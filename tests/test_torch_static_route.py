"""Port parity: K9, the static permutations of
graphblas_tpu_torch.kernels.static_route (plain version on the CPU),
against numpy ``x[perm]`` and against the JAX package's executors in
Pallas interpret mode, with their plans built as tests/test_static_route.py
builds them (benes_route + pack_masks, clos_route, GlobalPermutePlan), and
the unchecked row entry ``permute_rows`` at every payload width.  Every
comparison is exact: a permutation moves values without arithmetic."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphblas_tpu.kernels import static_route as JSR
from graphblas_tpu_torch import testing as GT
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


def _row_bytes(t):
    """The bytes of each row of ``t`` as an (n, w) uint8 array."""
    w = t.element_size() * t[0].numel() if len(t) else 1
    flat = t.reshape(-1).clone(memory_format=torch.contiguous_format)
    return flat.view(torch.uint8).numpy().reshape(len(t), w)


@pytest.mark.parametrize("pdt", [torch.int32, torch.int64])
@pytest.mark.parametrize("kind", list(GT.K9_PAYLOADS))
def test_permute_rows_plain_matches_numpy(kind, pdt):
    """The widened plain version (and ``permute_rows`` on CPU tensors) at
    every payload width, a struct row among them, through int32 and int64
    permutations, one and two payloads, at n = 0, 1 and 1000."""
    rng = np.random.default_rng(40)
    for n in (0, 1, 1000):
        x = GT.k9_payload(rng, n, kind)
        ids = torch.from_numpy(rng.integers(0, 1 << 20, n).astype(np.int32))
        p = rng.permutation(n)
        perm = torch.from_numpy(p).to(pdt)
        one = STR.permute_plain(x, perm)
        assert one.dtype == x.dtype and one.shape == x.shape
        # numpy moves the same bytes: rows of x through p
        np.testing.assert_array_equal(_row_bytes(one), _row_bytes(x)[p])
        gi, gx = STR.permute_rows(ids, perm, x)
        np.testing.assert_array_equal(gi.numpy(), ids.numpy()[p])
        assert GT.same_bits(gx, one) and GT.same_bits(
            STR.permute_rows(x, perm), one)


def test_permute_rows_matches_jax_global_permute():
    """The unchecked entry against the JAX ``global_permute`` in Pallas
    interpret mode on one (2048, 128) tile (fp32: the JAX executor's
    type), the int32 second payload against numpy, through the int64
    order a sort gives."""
    rng = np.random.default_rng(41)
    n = JSR.TILE_R * 128 - 999
    p = rng.permutation(n)
    plan = JSR.GlobalPermutePlan(p, n)
    x = rng.standard_normal(n).astype(np.float32)
    ids = rng.integers(-1 << 30, 1 << 30, n).astype(np.int32)
    gi, gx = STR.permute_rows(torch.from_numpy(ids), torch.from_numpy(p),
                              torch.from_numpy(x))
    want = np.asarray(JSR.global_permute(jnp.asarray(x), plan,
                                         interpret=True))
    np.testing.assert_array_equal(gx.numpy(), want)
    np.testing.assert_array_equal(gi.numpy(), ids[p])


@pytest.mark.parametrize("n", [1, 1000, 16385, 40_000])
def test_global_permute_plan_goes_through_permute_rows(n, monkeypatch):
    """``global_permute`` through a plan is one call of the unchecked
    entry on the plan's held permutation (K9's one kernel), and moves
    every element where x[perm] puts it."""
    rng = np.random.default_rng(42)
    perm = rng.permutation(n)
    x = rng.integers(-1 << 30, 1 << 30, n).astype(np.int32)
    plan = STR.GlobalPermutePlan(torch.from_numpy(perm), n)
    calls = []
    rows = STR.permute_rows

    def spy(*args):
        calls.append(args)
        return rows(*args)
    monkeypatch.setattr(STR, "permute_rows", spy)
    got = STR.global_permute(torch.from_numpy(x), plan)
    np.testing.assert_array_equal(got.numpy(), x[perm])
    assert len(calls) == 1 and len(calls[0]) == 2
    assert calls[0][1] is plan.perm
