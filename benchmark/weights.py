"""Seeded weights, made on the device in a few large draws.

Both sides get their weights here: the system under test in the dtypes its
modules hold, the reference in fp32 from the same draws rounded as the
system stores them, so the two start from the same numbers. The draws run
over the parameters sorted by name, in chunks of ``CHUNK`` bf16 standard
normals from one ``torch.Generator`` on the device; each parameter then
takes its values from its slice: norms' weights near 1 and their biases
near 0, matrices and kernels scaled by their fan-in, vectors small, and
the learned blend factors as drawn (none zero, so every branch and adapter
reaches the result).
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch
import torch.nn as nn

CHUNK = 2 ** 28  # standard normals a draw: 512 MB of bf16


def named(components: Dict[str, nn.Module]) -> Dict[str, Tuple[torch.nn.Parameter, str]]:
    """``{"prefix.name": (parameter, kind)}`` over the components' parameters;
    kind is ``norm_weight``, ``norm_bias``, ``mix`` or ``tensor``."""
    out = {}
    for prefix, module in components.items():
        for mod_name, mod in module.named_modules():
            for pname, p in mod.named_parameters(recurse=False):
                if isinstance(mod, (nn.GroupNorm, nn.LayerNorm)):
                    kind = "norm_weight" if pname == "weight" else "norm_bias"
                elif pname == "mix_factor":
                    kind = "mix"
                else:
                    kind = "tensor"
                full = ".".join(x for x in (prefix, mod_name, pname) if x)
                out[full] = (p, kind)
    return out


def _values(r: torch.Tensor, shape, kind: str) -> torch.Tensor:
    r = r.float().reshape(shape)
    if kind == "norm_weight":
        return 1.0 + 0.1 * r
    if kind == "norm_bias":
        return 0.1 * r
    if kind == "mix":
        return r
    if len(shape) >= 2:
        return r * (r[0].numel() ** -0.5)
    return 0.02 * r


def stream(shapes: Dict[str, Tuple[Tuple[int, ...], str]], seed: int,
           device) -> Iterator[Tuple[str, torch.Tensor]]:
    """``(name, fp32 values)`` in name order for ``{name: (shape, kind)}``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(torch.Size(s).numel() for s, _ in shapes.values())
    drawn, buf, pos = 0, None, 0
    for name in sorted(shapes):
        shape, kind = shapes[name]
        need, parts = torch.Size(shape).numel(), []
        while need:
            if buf is None or pos == buf.numel():
                n = min(CHUNK, total - drawn)
                buf = torch.randn(n, generator=gen, device=device, dtype=torch.bfloat16)
                drawn, pos = drawn + n, 0
            take = min(need, buf.numel() - pos)
            parts.append(buf[pos:pos + take])
            pos, need = pos + take, need - take
        yield name, _values(parts[0] if len(parts) == 1 else torch.cat(parts), shape, kind)


def shapes_of(components: Dict[str, nn.Module]) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    return {n: (tuple(p.shape), kind) for n, (p, kind) in named(components).items()}


def layout(components: Dict[str, nn.Module]) -> Dict[str, tuple]:
    """``{name: (shape, kind, dtype)}``: what a reference needs to hold the
    same parameters and round them alike."""
    return {n: (tuple(p.shape), kind, p.dtype) for n, (p, kind) in named(components).items()}


@torch.no_grad()
def fill_(components: Dict[str, nn.Module], seed: int, dtypes: Dict[str, torch.dtype] = None,
          shapes: Dict[str, Tuple[Tuple[int, ...], str]] = None) -> Dict[str, torch.dtype]:
    """Fill every parameter of ``components`` from ``seed``. ``shapes``: the
    whole set of parameters the draws run over, when ``components`` hold
    only some of them (default: theirs). ``dtypes`` (name -> dtype): round
    each value to that dtype first, as the system stores it (the
    reference's fp32 copy of a bf16 weight). Returns the parameters' dtypes
    by name."""
    params = named(components)
    device = next(iter(params.values()))[0].device
    shapes = shapes or shapes_of(components)
    if shapes_of(components).items() - shapes.items():
        raise ValueError("the components hold parameters the draws do not cover")
    for name, values in stream(shapes, seed, device):
        if name in params:
            if dtypes is not None:
                values = values.to(dtypes[name])
            params[name][0].copy_(values)
    return {n: p.dtype for n, (p, _) in params.items()}
