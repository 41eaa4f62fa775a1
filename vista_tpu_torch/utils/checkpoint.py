"""The weight bridge: upstream-key state dicts to and from the port's modules.

``load_vista_state_dict`` takes the flat dict of numpy arrays in the
upstream torch layout that ``vista_tpu.utils.checkpoint.export_vista_checkpoint``
writes, or a safetensors file with the same keys (the released
``vista.safetensors``), and loads each subset with ``strict=True``: a
missing or extra key raises. ``export_vista_state_dict`` is its inverse
(fp32 numpy arrays, the conditioner's encoder copy written too, as the
released files hold it), and ``upstream_state_dict`` the same from the
modules' state dicts of a training checkpoint.

- ``model.diffusion_model.*`` -> the VideoUNet, LoRA (``{q,k,v,out}_adapter_{down,up}``)
  and action (``{k,v}_adapter_action_control``) adapters included when the
  UNet has them;
- ``first_stage_model.decoder.*`` -> the temporal VAE decoder;
- ``first_stage_model.encoder.*`` -> the VAE encoder. The conditioner's
  copy of it (``conditioner.embedders.3.encoder.encoder.*``) is the same
  trunk: the port holds one encoder, as the JAX package does;
- ``conditioner.embedders.0.open_clip.model.visual.*`` -> the CLIP tower and
  ``conditioner.embedders.3.encoder.quant_conv.*`` -> ``quant_conv``.

The safetensors format is read and written here, without the
``safetensors`` package: an 8-byte little-endian header length, a JSON
header of each tensor's dtype, shape and byte offsets, then the raw
little-endian buffers. ``bin_to_state_dict`` and ``merge_lora_weights`` are
the reference's ``bin_to_st.py`` passes and the plain LoRA merge, in numpy,
as the JAX package has them; ``load_torch_bin`` reads a DeepSpeed-merged
pickle with ``weights_only=True``.

``save_checkpoint`` / ``load_checkpoint`` are the training run's own files
(the torch counterpart of the JAX package's Orbax pair): the trainer's state
and every module's state dict, written by ``torch.save`` to a temporary file
that ``os.replace`` then moves into place, read back with
``weights_only=True`` onto the CPU.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch
import torch.nn as nn

UNET_PREFIX = "model.diffusion_model."
DECODER_PREFIX = "first_stage_model.decoder."
ENCODER_PREFIX = "first_stage_model.encoder."
CLIP_PREFIX = "conditioner.embedders.0.open_clip.model.visual."
QUANT_PREFIX = "conditioner.embedders.3.encoder.quant_conv."
COND_ENCODER_PREFIX = "conditioner.embedders.3.encoder.encoder."

# safetensors dtype names <-> numpy; BF16 (no numpy dtype) is read as fp32
_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64,
              "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8,
              "BOOL": np.bool_}
_ST_NAMES = {np.dtype(v): k for k, v in _ST_DTYPES.items()}


def save_safetensors(path: str, state_dict: Mapping[str, Union[np.ndarray, torch.Tensor]]) -> None:
    """Write numpy arrays (or CPU tensors; bf16 ones as BF16) in the
    safetensors format, whole or not at all."""
    header: Dict[str, object] = {}
    buffers, offset = [], 0
    for key in sorted(state_dict):
        v = state_dict[key]
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            if v.dtype == torch.bfloat16:
                name, v = "BF16", v.contiguous().view(torch.int16).numpy()
            else:
                v = v.numpy()
                name = _ST_NAMES[v.dtype]
        else:
            v = np.asarray(v)
            name = _ST_NAMES[v.dtype]
        shape = list(v.shape)
        v = np.ascontiguousarray(v)  # (0-d arrays come back 1-d)
        header[key] = {"dtype": name, "shape": shape,
                       "data_offsets": [offset, offset + v.nbytes]}
        buffers.append(v)
        offset += v.nbytes
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for v in buffers:
            f.write(memoryview(v.reshape(-1).view(np.uint8)))
    os.replace(tmp, path)


def load_safetensors(path: str) -> Dict[str, np.ndarray]:
    """A safetensors file as numpy arrays (read-only views of a memory map;
    BF16 tensors converted to fp32 copies)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n) if header else None
    out = {}
    for key, meta in header.items():
        begin, end = meta["data_offsets"]
        raw, shape = np.asarray(data[begin:end]), tuple(meta["shape"])
        if meta["dtype"] == "BF16":
            bits = torch.from_numpy(np.array(raw)).view(torch.bfloat16)
            out[key] = bits.float().numpy().reshape(shape)
        else:
            out[key] = raw.view(_ST_DTYPES[meta["dtype"]]).reshape(shape)
    return out


def _subset(state: Mapping[str, np.ndarray], prefix: str) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: torch.from_numpy(np.array(v))
            for k, v in state.items() if k.startswith(prefix)}


def _load(module: nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    ref = module.state_dict()
    for k, v in sd.items():
        if k in ref:
            sd[k] = v.to(ref[k].dtype)
    module.load_state_dict(sd, strict=True)


def load_vista_state_dict(unet: Optional[nn.Module], decoder: Optional[nn.Module],
                          state: Union[str, Mapping[str, np.ndarray]],
                          encoder: Optional[nn.Module] = None,
                          conditioner: Optional[nn.Module] = None) -> None:
    """Load the subsets of ``state`` into the modules given (None skips one);
    ``conditioner`` is a ``GeneralConditioner`` (its CLIP tower and
    ``quant_conv``)."""
    if isinstance(state, str):
        state = load_safetensors(state)
    if unet is not None:
        _load(unet, _subset(state, UNET_PREFIX))
    if decoder is not None:
        _load(decoder, _subset(state, DECODER_PREFIX))
    if encoder is not None:
        _load(encoder, _subset(state, ENCODER_PREFIX))
    if conditioner is not None:
        _load(conditioner.clip_tower, _subset(state, CLIP_PREFIX))
        _load(conditioner.quant_conv, _subset(state, QUANT_PREFIX))


def save_checkpoint(path: str, trainer_state: Mapping,
                    modules: Mapping[str, Union[nn.Module, Mapping[str, torch.Tensor]]]) -> None:
    """Write ``{"trainer": trainer_state, "modules": {name: state_dict}}`` to
    ``path`` whole or not at all (``modules`` holds modules or their state
    dicts)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save({"trainer": dict(trainer_state),
                "modules": {name: m.state_dict() if isinstance(m, nn.Module) else dict(m)
                            for name, m in modules.items()}}, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict:
    """What :func:`save_checkpoint` wrote, its tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def upstream_state_dict(unet: Optional[Mapping[str, torch.Tensor]],
                        decoder: Optional[Mapping[str, torch.Tensor]],
                        encoder: Optional[Mapping[str, torch.Tensor]] = None,
                        conditioner: Optional[Mapping[str, torch.Tensor]] = None
                        ) -> Dict[str, np.ndarray]:
    """The modules' state dicts under the upstream prefixes, as fp32 numpy
    arrays (None skips one). The encoder goes out twice, as the first
    stage's and as the conditioner's copy."""
    out: Dict[str, np.ndarray] = {}
    for prefixes, sd in (((UNET_PREFIX,), unet), ((DECODER_PREFIX,), decoder),
                         ((ENCODER_PREFIX, COND_ENCODER_PREFIX), encoder)):
        for k, v in (sd or {}).items():
            for prefix in prefixes:
                out[prefix + k] = _numpy(v)
    for k, v in (conditioner or {}).items():
        for own, prefix in (("clip_tower.", CLIP_PREFIX), ("quant_conv.", QUANT_PREFIX)):
            if k.startswith(own):
                out[prefix + k[len(own):]] = _numpy(v)
                break
        else:
            raise KeyError(f"conditioner key {k!r} has no upstream name")
    return out


def export_vista_state_dict(unet: Optional[nn.Module], decoder: Optional[nn.Module],
                            encoder: Optional[nn.Module] = None,
                            conditioner: Optional[nn.Module] = None) -> Dict[str, np.ndarray]:
    """The inverse of :func:`load_vista_state_dict`: the modules' weights in
    the upstream layout (the counterpart of the JAX ``export_vista_checkpoint``)."""
    sd = lambda m: m.state_dict() if m is not None else None
    return upstream_state_dict(sd(unet), sd(decoder), sd(encoder), sd(conditioner))


def load_torch_bin(path: str) -> Dict[str, np.ndarray]:
    """A torch-pickle state dict (a DeepSpeed-merged ``pytorch_model.bin``,
    bare or under ``state_dict`` / ``module``) as numpy arrays; bf16 tensors
    become fp32."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "module"):
        if isinstance(obj, dict) and key in obj and isinstance(obj[key], dict):
            obj = obj[key]
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).detach().numpy()
            for k, v in obj.items()}


def bin_to_state_dict(sd: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The reference ``bin_to_st.py``, pass for pass:

    1. LoRA merge (``W += up @ down``) before the prefix strip, on the online
       and the ``model_ema`` copies alike; the EMA target of the out
       projection is the dot-stripped ``to_out0`` (the EMA's mangled names),
       the online one ``to_out.0``;
    2. only ``_forward_module.*`` keys survive, the prefix stripped, the
       EMA's ``decay`` / ``num_updates`` counters dropped (a dict with no
       prefixed key keeps every key but the counters);
    3. each ``model_ema.<mangled>`` replaces the online key whose name,
       ``model.`` and dots removed, is its mangled name.
    """
    out = dict(sd)
    for k in list(out):
        if "adapter_down" not in k:
            continue
        for proj in ("q", "k", "v"):
            if f"{proj}_adapter_down" in k:
                up_k = k.replace(f"{proj}_adapter_down", f"{proj}_adapter_up")
                pretrain_k = k.replace(f"{proj}_adapter_down", f"to_{proj}")
                break
        else:
            up_k = k.replace("out_adapter_down", "out_adapter_up")
            pretrain_k = k.replace("out_adapter_down",
                                   "to_out0" if "model_ema" in k else "to_out.0")
        lora = out[up_k] @ out[k]
        del out[k], out[up_k]
        out[pretrain_k] = out[pretrain_k] + lora

    if any("_forward_module" in k for k in out):
        out = {k.replace("_forward_module.", ""): v for k, v in out.items()
               if "_forward_module" in k and "decay" not in k and "num_updates" not in k}
    else:
        out = {k: v for k, v in out.items()
               if not ("model_ema" in k and ("decay" in k or "num_updates" in k))}

    mangled = {kk[6:].replace(".", ""): kk for kk in out if "model_ema" not in kk}
    for k in list(out):
        if "model_ema" not in k:
            continue
        orig_k = mangled.get(k[10:])
        if orig_k is None:
            raise KeyError(f"no online match for EMA key {k}")
        out[orig_k] = out.pop(k)
    return out


def merge_lora_weights(state_dict: Mapping[str, np.ndarray],
                       scale: float = 1.0) -> Dict[str, np.ndarray]:
    """Fold each LoRA adapter into its projection (``W += up @ down *
    scale``: ``{q,k,v}_adapter`` into ``to_{q,k,v}``, ``out_adapter`` into
    ``to_out.0``) and drop the adapter's keys."""
    out = dict(state_dict)
    for key in list(out):
        if key.endswith("_adapter_down.weight"):
            base = key[:-len("_adapter_down.weight")]
            up_key = base + "_adapter_up.weight"
            mod, _, proj = base.rpartition(".")
            target = f"{mod}.to_out.0.weight" if proj == "out" else f"{mod}.to_{proj}.weight"
            if up_key in out and target in out:
                out[target] = out[target] + (out[up_key] @ out[key]) * scale
                del out[key], out[up_key]
    return out
