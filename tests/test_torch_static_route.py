"""Port parity: K9, the static permutations of
graphblas_tpu_torch.kernels.static_route (plain version on the CPU),
against numpy ``x[perm]`` and against the JAX package's executors in
Pallas interpret mode, with their plans built as tests/test_static_route.py
builds them (benes_route + pack_masks, clos_route, GlobalPermutePlan).
Every comparison is exact: a permutation moves values without
arithmetic."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphblas_tpu.kernels import static_route as JSR
from graphblas_tpu_torch.kernels import static_route as STR
from torch_parity import cpu_default  # noqa: F401


@pytest.mark.parametrize("n,dtype", [(1, np.float32), (1000, np.int32),
                                     (4097, np.float32)])
def test_global_permute_matches_numpy(n, dtype):
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n).astype(dtype)
    perm = rng.permutation(n)
    plan = STR.GlobalPermutePlan(perm, n)
    got = STR.global_permute(torch.from_numpy(x), plan)
    np.testing.assert_array_equal(got.numpy(), x[perm])
    bare = STR.global_permute(torch.from_numpy(x), torch.from_numpy(perm))
    np.testing.assert_array_equal(bare.numpy(), x[perm])


def test_permutations_are_checked():
    x = torch.arange(256, dtype=torch.float32).reshape(2, 128)
    bad = {"repeat": np.zeros(256, np.int64),
           "range": np.arange(1, 257),
           "length": np.arange(255)}
    for perm in bad.values():
        with pytest.raises(ValueError):
            STR.global_permute(x, perm)
    with pytest.raises(ValueError):
        STR.GlobalPermutePlan(np.arange(1, 257), 256)
    with pytest.raises(ValueError):
        STR.global_permute(x, STR.GlobalPermutePlan(np.arange(255), 255))
    with pytest.raises(ValueError):                  # not an (R, 128) tile
        STR.tile_permute(x.reshape(4, 64), np.arange(256))
    cols = np.tile(np.arange(2), (128, 1))
    cols[3] = 0                                      # column 3 repeats
    with pytest.raises(ValueError):
        STR.sublane_permute(x, cols)
    with pytest.raises(TypeError):
        STR.global_permute(x, np.arange(256, dtype=np.float32))


def test_sublane_permute_matches_jax_interpret():
    rng = np.random.default_rng(34)
    R = 64
    perm = np.stack([rng.permutation(R) for _ in range(128)])  # per lane
    dists, masks = JSR.benes_route(perm)
    bits = JSR.pack_masks(masks).T.copy()                      # (R, 128)
    x = rng.standard_normal((R, 128)).astype(np.float32)
    want = np.asarray(JSR.sublane_permute(jnp.asarray(x), jnp.asarray(bits),
                                          dists, interpret=True))
    np.testing.assert_array_equal(want, np.take_along_axis(x.T, perm, 1).T)
    got = STR.sublane_permute(torch.from_numpy(x), perm)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("R", [8, 64])
def test_tile_permute_matches_jax_interpret(R):
    rng = np.random.default_rng(35 + R)
    perm = rng.permutation(R * 128)
    plan = JSR.clos_route(perm, R, 128)
    x = rng.standard_normal((R, 128)).astype(np.float32)
    want = np.asarray(JSR.tile_permute(jnp.asarray(x), plan, interpret=True))
    got = STR.tile_permute(torch.from_numpy(x), perm)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  x.reshape(-1)[perm].reshape(R, 128))


@pytest.mark.slow
def test_global_permute_matches_jax_interpret():
    """Two (2048, 128) tiles, not tile-aligned, as the JAX test."""
    rng = np.random.default_rng(36)
    n = 2 * JSR.TILE_R * 128 - 777
    perm = rng.permutation(n)
    x = rng.standard_normal(n).astype(np.float32)
    want = np.asarray(JSR.global_permute(
        jnp.asarray(x), JSR.GlobalPermutePlan(perm, n), interpret=True))
    got = STR.global_permute(torch.from_numpy(x),
                             STR.GlobalPermutePlan(perm, n))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), x[perm])
