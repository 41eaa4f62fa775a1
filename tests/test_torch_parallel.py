"""The port's mesh, sharding rule and collectives against the JAX package
(no JAX jit):

- ``make_mesh``: sizes, the ``-1`` inference and the errors, case by case
  against ``vista_tpu.parallel.make_mesh`` on as many of conftest's virtual
  devices as there are ranks (one rank without a group, two gloo ranks);
- ``fsdp_shard_dim`` against ``fsdp_param_specs`` on the tiny UNet's
  parameters (LoRA and action adapters included), carried across by the
  weight bridge's key map: the same tensors are sliced, at ``min_size`` 128
  and at the default;
- on 2 ranks at an uneven token count (s = 9: 5 and 4): the frame <-> token
  all-to-all in both layouts, bit for bit against the whole tensor and back;
  the frame gather, the gather along each dim, the bucketed gradient mean;
  the partial-sum ``gn_affine`` against the whole one, to 1e-6;
- ``VideoUNet.blocks`` holds each parameter once (the units that
  weight-sharded sampling gathers);
- on the same 2 ranks, the band code of ``height`` mode against the
  whole-frame op, to 1e-6 of its largest magnitude, at an uneven level (9
  rows: bands 4 / 5) and at empty bands: the UNet's 3x3 conv at stride 1
  and 2, its 1x1 conv, ``Upsample`` (``F.conv2d`` after the interpolation),
  the band-summed ``GroupNorm32`` (``F.group_norm``), and band-local queries
  against K and V gathered over the bands (``attention_plain``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_parallel_ranks import collectives, mesh_outcome
from tests.torch_ranks import start_ranks
from tests.torch_threads import one_thread  # noqa: F401
from vista_tpu.models.unet import VideoUNet as JVideoUNet
from vista_tpu.models.unet import VideoUNetConfig as JVideoUNetConfig
from vista_tpu.parallel import fsdp_param_specs
from vista_tpu.parallel import make_mesh as jmake_mesh
from vista_tpu.utils import torch_import as ti
from vista_tpu_torch.models.unet import VideoUNet, VideoUNetConfig
from vista_tpu_torch.parallel.mesh import fsdp_shard_dim
from vista_tpu_torch.utils.checkpoint import UNET_PREFIX

MESH_CASES = [None, {"data": -1}, {"data": 1}, {"data": 2}, {"fsdp": 2}, {"data": -1, "fsdp": 2},
              {"data": 2, "fsdp": -1}, {"data": 1, "fsdp": 2}, {"data": -1, "fsdp": -1},
              {"data": 3}, {"data": -1, "fsdp": 3}, {"data": 2, "fsdp": 2}]


@pytest.fixture(scope="module")
def two_ranks():
    return start_ranks(collectives, 2, (MESH_CASES,)).results()


def _jax_outcome(axis_sizes, n):
    try:
        mesh = jmake_mesh(axis_sizes, devices=jax.devices()[:n])
    except ValueError as e:
        return "err", str(e).replace("devices", "ranks")
    return "ok", {a: dict(mesh.shape).get(a, 1) for a in ("data", "fsdp")}


@pytest.mark.parametrize("case", MESH_CASES, ids=str)
def test_make_mesh_matches_jax(two_ranks, case):
    i = MESH_CASES.index(case)
    assert mesh_outcome(case) == _jax_outcome(case, 1)
    for out in two_ranks:
        assert out["mesh"][i] == _jax_outcome(case, 2)


@pytest.mark.parametrize("min_size", [128, 2**16])
def test_fsdp_shard_dim_matches_jax(min_size):
    jcfg = dataclasses.replace(JVideoUNetConfig().tiny(), add_lora=True, action_control=True)
    t = jcfg.num_frames
    shapes = jax.eval_shape(lambda: JVideoUNet(jcfg).init(
        jax.random.key(0), jnp.zeros((t, 8, 8, 8)), jnp.zeros((t,)),
        jnp.zeros((1, 1, jcfg.context_dim + 2432)), jnp.zeros((1, jcfg.adm_in_channels)),
        jnp.zeros((t,)), t))["params"]
    mesh = jmake_mesh({"data": 4, "fsdp": 2})
    specs = fsdp_param_specs(shapes, mesh, min_size=min_size)
    sliced = jax.tree.map(lambda s, spec: np.full(s.shape, float(any(spec)), np.float32),
                          shapes, specs, is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
    ref = {k[len(UNET_PREFIX):]: bool(v.reshape(-1)[0]) for k, v in
           ti.export_key_map(sliced, ti.unet_key_map(jcfg), UNET_PREFIX).items()}
    with torch.device("meta"):
        unet = VideoUNet(dataclasses.replace(VideoUNetConfig().tiny(), add_lora=True,
                                             action_control=True))
    got = {n: fsdp_shard_dim(p.shape, 2, min_size) is not None
           for n, p in unet.named_parameters()}
    assert set(got) == set(ref)
    assert got == ref
    assert any(got.values()) and not all(got.values())  # some sliced, some whole


def test_all_to_all_round_trips_at_uneven_splits(two_ranks):
    for out in two_ranks:
        assert out["splits"] == [5, 4]
        for seq_major in (True, False):
            assert out[f"a2a_{seq_major}"] == (True, True, True, True), seq_major
        assert out["gather_frames"]
        assert out["gather_dims"] == [True] * 4
        assert out["grad_mean"]


def test_partial_sum_gn_affine_matches_whole(two_ranks):
    for out in two_ranks:
        assert max(out["gn_rel"]) <= 1e-6


def test_unet_blocks_hold_each_parameter_once():
    with torch.device("meta"):
        unet = VideoUNet(dataclasses.replace(VideoUNetConfig().tiny(), add_lora=True,
                                             action_control=True))
    params = [p for block in unet.blocks() for p in block.parameters()]
    assert len(params) == len({id(p) for p in params}) == len(list(unet.parameters()))


HEIGHT_CASES = [f"{op} {rows} rows" for rows in (9, 1)
                for op in ("conv", "conv_s2", "conv_1x1", "upsample", "group_norm", "attention")
                ] + ["conv_s2 2 rows"]


@pytest.mark.parametrize("case", HEIGHT_CASES)
def test_height_band_ops_match_the_whole_frame(two_ranks, case):
    for out in two_ranks:
        assert sorted(out["height"]) == sorted(HEIGHT_CASES)
        assert out["height"][case] <= 1e-6, out["height"]
