"""The port's SSD scan (plain versions and dispatch) against the JAX
package's, on shared numpy inputs.

The JAX side runs as its own tests run it: ``ref.*`` and the Pallas kernel
``ssd_scan_pallas`` in interpret mode.  Tolerances are in ulps of the
largest output magnitude (as in ``tests/test_backend_fuzz.py``): the two
frameworks sum their dots in different orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as jdispatch
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan_pallas
from repro_torch.kernels import dispatch, ops
from repro_torch.kernels import ssd_scan as k3
from repro_torch.kernels import ref as tref

# the chunked versions do the same dots on both sides; only the order of
# each dot's sum differs
CHUNKED_ULPS = 16
# the sequential oracle against a chunked scan: another algorithm, whose
# decays e^{l_t - l_s} are formed from differences of cumulative sums
ORACLE_ULPS = 64

DIMS = [
    # (L, H, P, N, chunk): tests/test_kernels.py's shapes
    (64, 2, 16, 8, 16),
    (128, 1, 32, 16, 32),
    (96, 3, 8, 4, 32),
]


def _inputs(rng, L, H, P, N, batch=()):
    return (rng.standard_normal((*batch, L, H, P)).astype(np.float32),
            rng.uniform(0.01, 0.2, (*batch, L, H)).astype(np.float32),
            -rng.uniform(0.5, 2.0, (H,)).astype(np.float32),
            rng.standard_normal((*batch, L, N)).astype(np.float32),
            rng.standard_normal((*batch, L, N)).astype(np.float32))


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _ulps(got, want):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.max(np.abs(got - want))
                 / np.spacing(np.float32(np.max(np.abs(want)))))


@pytest.mark.parametrize("dims", DIMS)
def test_chunk_decay_matches_jax(dims, rng):
    L, H, P, N, chunk = dims
    _, dt, A, _, _ = _inputs(rng, L, H, P, N)
    got = tref.chunk_decay(torch.from_numpy(dt), torch.from_numpy(A), chunk)
    want = np.asarray(jref.chunk_decay(jnp.asarray(dt), jnp.asarray(A), chunk))
    # A * a running sum of at most `chunk` terms, summed in the same order
    np.testing.assert_allclose(got.numpy(), want, rtol=4e-7, atol=0)
    with pytest.raises(ValueError, match="divisible"):
        tref.chunk_decay(torch.from_numpy(dt), torch.from_numpy(A), L + 1)


@pytest.mark.parametrize("dims", DIMS)
def test_scan_plain_versions_match_jax_and_the_interpret_kernel(dims, rng):
    L, H, P, N, chunk = dims
    arrays = _inputs(rng, L, H, P, N)
    oracle = np.asarray(jref.ssd_scan_ref(*_j(arrays)))
    chunked = np.asarray(jref.ssd_scan_chunked_ref(*_j(arrays), chunk=chunk))
    pallas = np.asarray(ssd_scan_pallas(*_j(arrays), chunk=chunk,
                                        interpret=True))
    mine_oracle = tref.ssd_scan_ref(*_t(arrays))
    mine = tref.ssd_scan_chunked_ref(*_t(arrays), chunk=chunk)
    assert _ulps(mine_oracle, oracle) <= CHUNKED_ULPS
    assert _ulps(mine, chunked) <= CHUNKED_ULPS
    assert _ulps(mine, pallas) <= CHUNKED_ULPS
    assert _ulps(mine, oracle) <= ORACLE_ULPS
    # the port's public entry point on CPU tensors is the plain version
    assert torch.equal(ops.ssd_scan(*_t(arrays), chunk=chunk), mine)


def test_dispatch_pads_any_length_with_dt0_steps(rng):
    """A length that is not a multiple of the chunk is padded with dt = 0
    steps and sliced back, as the JAX package's ``dispatch.ssd`` does."""
    L, H, P, N = 50, 16, 8, 16          # reduced mamba2-130m: Q 16, L 50
    arrays = _inputs(rng, L, H, P, N)
    got = dispatch.ssd(*_t(arrays), chunk=16)
    want = jdispatch.ssd(*_j(arrays), chunk=16, backend="xla")
    assert got.shape == (L, H, P)
    assert _ulps(got, want) <= CHUNKED_ULPS
    assert _ulps(got, jref.ssd_scan_ref(*_j(arrays))) <= ORACLE_ULPS
    # Q = min(chunk, L): a short sequence is one chunk, unpadded
    short = [a[:7] if a.ndim > 1 else a for a in arrays]
    assert _ulps(dispatch.ssd(*_t(short), chunk=16),
                 jref.ssd_scan_ref(*_j(short))) <= ORACLE_ULPS


def test_batched_call_equals_rows_one_by_one(rng):
    """The leading batch dimension stands in for the reference's vmap:
    every row is the unbatched call's result, bit for bit."""
    arrays = _inputs(rng, 40, 3, 8, 4, batch=(3,))
    got = dispatch.ssd(*_t(arrays), chunk=16)
    assert got.shape == (3, 40, 3, 8)
    for b in range(3):
        row = [a[b] if a.ndim > 1 else a for a in arrays]
        assert torch.equal(dispatch.ssd(*_t(row), chunk=16), got[b])
        want = jref.ssd_scan_ref(*_j(row))
        assert _ulps(got[b], want) <= ORACLE_ULPS


def test_scan_chunk_table_and_backends():
    assert dispatch.scan_chunk("hopper", 100) == 128
    assert dispatch.scan_chunk("torch", 2048) == 256
    x = torch.zeros(8, 1, 4)
    dt, A, B = torch.zeros(8, 1), torch.zeros(1), torch.zeros(8, 2)
    with pytest.raises(ValueError, match="hopper"):
        dispatch.ssd(x, dt, A, B, B, backend="hopper")
    with pytest.raises(ValueError, match="unknown backend"):
        dispatch.ssd(x, dt, A, B, B, backend="pallas")


def test_chunk_invariance(rng):
    """Chunk size is a tiling choice: the results must not depend on it."""
    arrays = _t(_inputs(rng, 128, 2, 8, 4))
    outs = [tref.ssd_scan_chunked_ref(*arrays, chunk=c)
            for c in (16, 32, 64, 128)]
    for o in outs[1:]:
        np.testing.assert_allclose(o.numpy(), outs[0].numpy(), rtol=2e-4,
                                   atol=2e-4)


def test_state_decay_property(rng):
    """With strongly negative A the state forgets: doubling early input
    must not change late outputs materially."""
    L, H, P, N = 64, 1, 4, 4
    x = rng.standard_normal((L, H, P)).astype(np.float32)
    dt = np.full((L, H), 0.5, np.float32)
    A = np.array([-8.0], np.float32)
    B = rng.standard_normal((L, N)).astype(np.float32)
    C = rng.standard_normal((L, N)).astype(np.float32)
    y1 = tref.ssd_scan_ref(*_t((x, dt, A, B, C))).numpy()
    x2 = x.copy()
    x2[:4] *= 2
    y2 = tref.ssd_scan_ref(*_t((x2, dt, A, B, C))).numpy()
    np.testing.assert_allclose(y1[-8:], y2[-8:], rtol=1e-3, atol=1e-3)
    assert not np.allclose(y1[:4], y2[:4])


def _fmas_by_loops(batch, L, H, P, N, Q):
    """The FMAs ``y`` needs, one term at a time: per batch row and chunk,
    ``C_t . B_s`` for s <= t once (shared by the heads); per head, M @ x
    over s <= t, the carry on every chunk but the first and the state
    update on every chunk but the last."""
    total = 0
    nc = L // Q
    for _ in range(batch):
        for c in range(nc):
            for t in range(Q):
                total += (t + 1) * N
            for _ in range(H):
                for t in range(Q):
                    total += (t + 1) * P
                if c > 0:
                    total += Q * N * P
                if c < nc - 1:
                    total += Q * N * P
    return total


@pytest.mark.parametrize("shape", [
    # (batch, L, H, P, N, Q): one chunk, two, three; the reduced config;
    # a ragged Q
    (1, 40, 3, 8, 4, 40),
    (2, 32, 2, 8, 16, 16),
    (1, 96, 3, 8, 4, 32),
    (4, 64, 16, 8, 16, 16),
    (1, 154, 1, 5, 3, 77),
])
def test_ssd_scan_fmas_count_what_y_needs(shape):
    assert k3.fmas(*shape) == _fmas_by_loops(*shape)


def test_ssd_scan_fmas_full_width_recount():
    """The full-width mamba2-130m scan of a 256-step prefill (H 24, P 64,
    N 128, Q 128): C B^T once a chunk, a carry on the second chunk only and
    a state update on the first only."""
    tri = 128 * 129 // 2
    want = 2 * (tri * 128 + 24 * tri * 64) + 2 * 24 * 128 * 128 * 64
    assert k3.fmas(1, 256, 24, 64, 128, 128) == want
    # batch rows add up; one chunk has neither carry nor state update
    assert k3.fmas(4, 2048, 24, 64, 128, 128) == 4 * k3.fmas(1, 2048, 24, 64, 128, 128)
    assert k3.fmas(1, 40, 24, 64, 128, 40) == 40 * 41 // 2 * (128 + 24 * 64)


def _tasks_by_loops(L, Q, H, P, N, rows):
    """CTAs of the two kernels a batch row, counted tile by tile."""
    t = k3.TILE
    nc = L // Q
    tiles = range(0, Q, t)
    cb = sum(1 for _ in range(nc) for ti in tiles for si in tiles if si <= ti)
    ds = sum(1 for _ in range(nc - 1) for _ in range(H)
             for _ in range(0, N, t) for _ in range(0, P, t))
    out = sum(1 for _ in range(nc) for _ in range(H) for _ in range(0, Q, rows)
              for _ in range(0, P, t))
    return cb + ds, out


@pytest.mark.parametrize("shape", [
    # (L, Q, H, P, N): the served prefills (40, 77, 150 padded to 256),
    # 2048 at chunk 128 and 256, and the reduced config
    (40, 40, 24, 64, 128), (77, 77, 24, 64, 128), (256, 128, 24, 64, 128),
    (2048, 128, 24, 64, 128), (2048, 256, 24, 64, 128), (64, 16, 16, 8, 16),
])
def test_ssd_scan_plan_covers_every_tile_and_ignores_batch(shape):
    """The plan's grids cover every tile once, and the plan is a function
    of the shapes alone: it takes no batch size, so batch 1 and batch 4 get
    the same tiles and every element the same arithmetic."""
    import inspect

    assert "batch" not in inspect.signature(k3.plan).parameters
    p = k3.plan(*shape)
    assert p == k3.plan(*shape) and p.kernels == 2
    assert (p.grid_a, p.grid_b) == _tasks_by_loops(*shape, k3.ROWS)
    L, Q, H, P, N = shape
    # at least one output CTA for every head of every chunk
    assert p.grid_b >= (L // Q) * H


def test_ssd_scan_plan_at_the_served_lengths():
    """Output tiles of 32 rows, so a batch-1 prefill of 256 steps gives
    192 output CTAs for the 132 SMs; one chunk (prompts of 40 and 77) has
    no state tasks, only C B^T."""
    assert k3.plan(256, 128, 24, 64, 128) == (2, 2 * 3 + 24 * 2, 2 * 24 * 4)
    assert k3.plan(40, 40, 24, 64, 128) == (2, 1, 24 * 2)
    assert k3.plan(77, 77, 24, 64, 128) == (2, 3, 24 * 3)
    with pytest.raises(ValueError, match="divisible"):
        k3.plan(100, 64, 24, 64, 128)
