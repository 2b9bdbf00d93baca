"""The port's code over several ranks against the JAX package's.

- ``repro_torch.launch.mesh.make_test_mesh`` over a process group, and
  the port's collectives and ``shard_map``
  (``repro_torch.distributed.collectives``);
- MoE's expert-parallel path (``models/moe.py::_moe_apply_shardmap``);
- the GPipe pipeline (``distributed/pipeline.py``);
- the hierarchical gradient reduce (``launch/multipod.py``);
- the collective-byte count (``launch/hlo_analysis.py::collective_bytes``).

The JAX references run once, in a subprocess with 4 forced host devices
(this process's JAX has one); the port runs once on 4 gloo ranks spawned
on the CPU.  Both write their results to files that the tests below
compare.  Inputs are seeded with numpy; the MoE layer is the JAX
``moe_init`` of ``tests/conftest.py::small_moe``'s shape (E 8, K 2, D 16,
F 32, x (4, 16, 16)) on a (2, 2) ``("data", "model")`` mesh under the
train rules, which shard the experts over ``model`` and the batch over
``data`` (deepseek-v3's config keeps the sequence whole): 32 tokens a
rank, the same on both ranks of a ``model`` pair.
"""
import collections
import json
import multiprocessing
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
E, K, D, FF, B, S = 8, 2, 16, 32, 4, 16
CFS = (8.0, 1.0)
MODES = ("exact", "segmented3")
# EP against JAX's EP: exact fp32 within the reference's own EP-against-
# group-local bound (tests/test_moe_shardmap.py); segmented3 within 64
# fp32 ulps of the largest output (tests/test_backend_fuzz.py's bound);
# gradients within the reference test's 5e-3
EXACT_BOUND, ULPS, GRAD_BOUND = 2e-4, 64, 5e-3
PIPE_S, PIPE_M, PIPE_MB, PIPE_D = 4, 6, 3, 8
PIPE_BOUND = 2e-5
JOIN_S = 120
T_LOC = B // 2 * S


def _small_cfg(cfg, cf):
    import dataclasses

    return dataclasses.replace(
        cfg, d_model=D, d_ff=FF,
        moe=dataclasses.replace(cfg.moe, n_experts=E, top_k=K,
                                capacity_factor=cf, n_shared=0))


def _capacity(T, cf):
    return max(4, -(-int(T * K / E * cf) // 4) * 4)


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    g = {"w": (rng.standard_normal(512) * 0.01).astype(np.float32),
         "b": (rng.standard_normal((3, 100)) * 0.01).astype(np.float32)}
    e = {k: (rng.standard_normal(v.shape) * 1e-4).astype(np.float32)
         for k, v in g.items()}
    xs = rng.standard_normal((PIPE_M, PIPE_MB, PIPE_D)).astype(np.float32)
    w = (rng.standard_normal((PIPE_S, PIPE_D, PIPE_D))
         / PIPE_D ** 0.5).astype(np.float32)
    return x, g, e, xs, w


# ---------------------------------------------------------------------------
# the JAX references (run as a script in a subprocess with 4 host devices)
# ---------------------------------------------------------------------------

def _jax_reference(out_path):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch
    from repro.core.numerics import NumericsConfig
    from repro.core.policy import NumericsPolicy, PolicyRule
    from repro.distributed import pipeline
    from repro.distributed.sharding import rules_for, use_mesh_rules
    from repro.launch import hlo_analysis
    from repro.launch.mesh import make_test_mesh
    from repro.launch.multipod import hierarchical_grad_reduce
    from repro.models import moe
    from repro.models.layers import unzip
    from repro.numerics import nmatmul, numerics_scope

    assert len(jax.devices()) == WORLD
    num = {"exact": NumericsConfig(mode="exact", compute_dtype="float32"),
           "segmented3": NumericsConfig(mode="segmented", seg_passes=3,
                                        backend="xla")}
    x, g, e, xs, w = _inputs()
    out, coll = {}, {}
    base = get_arch("deepseek-v3-671b").reduced()
    params = unzip(moe.moe_init(jax.random.PRNGKey(0),
                                _small_cfg(base, 8.0)))[0]
    for k, v in params.items():
        out[f"param_{k}"] = np.asarray(v)
    mesh = make_test_mesh((2, 2), ("data", "model"))
    for cf in CFS:
        cfg = _small_cfg(base, cf)
        with use_mesh_rules(mesh, rules_for(cfg, "train")):
            for mode in MODES:
                f = jax.jit(lambda p, xx, c=cfg, n=num[mode]:
                            moe.moe_apply(p, xx, c, n))
                out[f"ep_{mode}_{cf}"] = np.asarray(f(params, x))
                coll[f"ep_{mode}_{cf}"] = hlo_analysis.collective_bytes(
                    f.lower(params, x).compile().as_text()).by_kind
            if cf == 8.0:
                def loss(p, xx, c=cfg):
                    return jnp.sum(moe.moe_apply(p, xx, c, num["exact"]) ** 2)

                gf = jax.jit(jax.grad(loss))
                for k, v in gf(params, x).items():
                    out[f"grad_{k}"] = np.asarray(v)
                coll["grad"] = hlo_analysis.collective_bytes(
                    gf.lower(params, x).compile().as_text()).by_kind
                pol = NumericsPolicy((PolicyRule("expert0.*",
                                                 num["segmented3"]),),
                                     default=num["exact"])
                out["hetero"] = np.asarray(jax.jit(
                    lambda p, xx: moe.moe_apply(p, xx, cfg, pol))(params, x))
        # the routing of each data shard, as the EP body computes it
        C = _capacity(T_LOC, cf)
        for d in range(2):
            xt = jnp.asarray(x[2 * d:2 * d + 2]).reshape(-1, D)
            logits = jnp.einsum("td,de->te", xt, params["router"])
            _, eidx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), K)
            ea = eidx.reshape(-1)
            order = jnp.argsort(ea)
            es = ea[order]
            counts = jnp.bincount(es, length=E)
            starts = jnp.concatenate([jnp.zeros((1,), counts.dtype),
                                      jnp.cumsum(counts)[:-1]])
            pos = jnp.arange(ea.shape[0]) - starts[es]
            keep = jnp.zeros(ea.shape, bool).at[order].set(pos < C)
            out[f"eidx_{cf}_{d}"] = np.asarray(eidx)
            out[f"keep_{cf}_{d}"] = np.asarray(keep).reshape(-1, K)

    pod = make_test_mesh((2, 2), ("pod", "data"))
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    plain, _ = hierarchical_grad_reduce(pod, jg, compress=False)
    comp, errs = hierarchical_grad_reduce(
        pod, jg, {k: jnp.asarray(v) for k, v in e.items()}, compress=True)
    for k in g:
        out[f"mp_plain_{k}"] = np.asarray(plain[k])
        out[f"mp_comp_{k}"] = np.asarray(comp[k])
        out[f"mp_err_{k}"] = np.asarray(errs[k])

    def stage(wi, h):
        with numerics_scope(num["segmented3"]):
            return jnp.tanh(nmatmul(h, wi))

    want = jnp.asarray(xs)
    for s in range(PIPE_S):
        want = stage(jnp.asarray(w[s]), want)
    out["pipe_want"] = np.asarray(want)
    try:
        pipeline.pipeline_apply(make_test_mesh((WORLD,), ("pipe",)),
                                lambda p, h: stage(p["w"], h),
                                {"w": jnp.asarray(w)}, jnp.asarray(xs))
        fault = "none"
    except ValueError as err:
        fault = str(err)
    out["pipe_fault"] = np.asarray(fault)
    out["coll"] = np.asarray(json.dumps(coll))
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, __file__, str(path)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ref = dict(np.load(path))
    ref["coll"] = json.loads(str(ref["coll"]))
    return ref


# ---------------------------------------------------------------------------
# the port on 4 gloo ranks
# ---------------------------------------------------------------------------

def _measure_received(received):
    """Wrap the process-group calls the collectives make, adding what
    each hands back to this rank to ``received`` by kind."""
    import torch.distributed as dist

    def nbytes(t):
        return t.numel() * t.element_size()

    def wrap(name, kind, size):
        real = getattr(dist, name)

        def call(*args, **kwargs):
            result = real(*args, **kwargs)
            received[kind] += size(*args)
            return result
        setattr(dist, name, call)

    wrap("all_to_all_single", "all-to-all", lambda out, *_: nbytes(out))
    wrap("all_reduce", "all-reduce", lambda t, *_: nbytes(t))
    wrap("all_gather", "all-gather",
         lambda parts, *_: sum(nbytes(p) for p in parts))
    wrap("broadcast", "collective-permute", lambda t, *_: nbytes(t))
    wrap("batch_isend_irecv", "collective-permute",
         lambda ops: sum(nbytes(op.tensor) for op in ops
                         if op.op is dist.irecv))


def _rank_main(rank, store, ref_path, out_dir):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.core.numerics import NumericsConfig
    from repro_torch.core.policy import NumericsPolicy, PolicyRule
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.distributed.sharding import P, rules_for, use_mesh_rules
    from repro_torch.launch import hlo_analysis
    from repro_torch.launch.mesh import init_ranks, make_test_mesh
    from repro_torch.launch.multipod import hierarchical_grad_reduce
    from repro_torch.models import moe
    from repro_torch.numerics import nmatmul, numerics_scope

    init_ranks("cpu", rank, WORLD, f"file://{store}")
    received = collections.Counter()
    _measure_received(received)
    ref = np.load(ref_path)
    num = {"exact": NumericsConfig(mode="exact", compute_dtype="float32"),
           "segmented3": NumericsConfig(mode="segmented", seg_passes=3)}
    x, g, e, xs, w = _inputs()
    out, counts = {}, {}

    def counted(tag, fn):
        received.clear()
        with col.count_collectives() as stats:
            result = fn()
        counts[tag] = {"counted": dict(stats.by_kind),
                       "received": dict(received)}
        return result

    # the mesh, and the collectives' semantics on seeded blocks
    mesh = make_test_mesh((2, 2), ("data", "model"), device="cpu")
    out["coords"] = np.asarray([mesh.coords["data"], mesh.coords["model"]])
    # a mesh smaller than the world: the ranks past it hold no coordinate
    half = make_test_mesh((2,), ("pipe",), device="cpu")
    out["half"] = np.asarray(-1 if half.coords is None
                             else half.coords["pipe"])
    for axes in (("data",), ("model",), ("data", "model"), ("model", "data")):
        tag = "_".join(axes)
        out[f"members_{tag}"] = np.asarray(mesh.group(axes)[1])
        out[f"index_{tag}"] = np.asarray(col.axis_index(mesh, axes))
        blk = torch.arange(4 * 3 * 2, dtype=torch.float32).reshape(4, 3, 2) \
            + 100 * rank
        out[f"a2a_{tag}"] = col.all_to_all(blk, mesh, axes, 0, 1).numpy()
        out[f"psum_{tag}"] = col.psum(blk, mesh, axes).numpy()
        out[f"pmean_{tag}"] = col.pmean(blk, mesh, axes).numpy()
    out["bcast"] = col.broadcast(torch.full((3,), float(rank)), mesh,
                                 ("data", "model"), 2).numpy()
    out["perm"] = col.ppermute(torch.full((2,), float(rank)), mesh, "model",
                               [(0, 1)]).numpy()

    # shard_map round trips, and their gradient
    full = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (4, 6, 8)).astype(np.float32))
    for tag, spec in (("rep", P()), ("dm", P("data", "model")),
                      ("md0", P(("model", "data"))), ("m2", P(None, None,
                                                              "model"))):
        leaf = full.clone().requires_grad_()
        y = col.shard_map(lambda t: t * 2.0, mesh, (spec,), spec)(leaf)
        (y * full).sum().backward()
        out[f"rt_{tag}"] = y.detach().numpy()
        out[f"rt_grad_{tag}"] = leaf.grad.numpy()
        out[f"rt_local_{tag}"] = np.asarray(col.shard_map(
            lambda t: torch.as_tensor(t.shape), mesh, (spec,), P())(full))

    # the collectives' gradients through shard_map: the single program's
    ramp = torch.arange(8, dtype=torch.float32)
    dm = P(("data", "model"))
    for tag, body, specs in (
            ("psum", lambda v: col.psum(v, mesh, ("data", "model")),
             (dm, P())),
            ("pmean", lambda v: col.pmean(v, mesh, ("data", "model")),
             (dm, P())),
            ("bcast", lambda v: col.broadcast(v, mesh, ("data", "model"), 2),
             (dm, P())),
            ("perm", lambda v: col.ppermute(v, mesh, "model",
                                            [(0, 1), (1, 0)]),
             (P("model"), P("model")))):
        leaf = ramp.clone().requires_grad_()
        y = col.shard_map(body, mesh, (specs[0],), specs[1])(leaf)
        (y * (1 + torch.arange(y.numel()))).sum().backward()
        out[f"dgrad_{tag}"] = leaf.grad.numpy()

    # expert-parallel MoE
    base = get_arch("deepseek-v3-671b").reduced()
    params = {k: torch.as_tensor(ref[f"param_{k}"])
              for k in ("router", "wi", "wg", "wo")}
    xt = torch.as_tensor(x)
    for cf in CFS:
        cfg = _small_cfg(base, cf)
        with use_mesh_rules(mesh, rules_for(cfg, "train")):
            for mode in MODES:
                out[f"ep_{mode}_{cf}"] = counted(
                    f"ep_{mode}_{cf}", lambda: moe.moe_apply(
                        params, xt, cfg, num[mode])).numpy()
            if cf == 8.0:
                leaves = {k: v.clone().requires_grad_()
                          for k, v in params.items()}

                def grads():
                    y = moe.moe_apply(leaves, xt, cfg, num["exact"])
                    (y ** 2).sum().backward()
                counted("grad", grads)
                for k, v in leaves.items():
                    out[f"grad_{k}"] = v.grad.numpy()
                pol = NumericsPolicy((PolicyRule("expert0.*",
                                                 num["segmented3"]),),
                                     default=num["exact"])
                out["hetero"] = counted("hetero", lambda: moe.moe_apply(
                    params, xt, cfg, pol)).numpy()
        # this rank's shard, routed as the EP body routes it
        d = mesh.coords["data"]
        shard = xt[2 * d:2 * d + 2].reshape(1, -1, D)
        _, eidx, _, inv = moe._route(shard, params["router"], cfg,
                                     moe.capacity(cfg, shard.shape[1]))
        out[f"eidx_{cf}"] = eidx[0].numpy()
        out[f"keep_{cf}"] = (inv[0] >= 0).numpy()
    cfg = _small_cfg(base, 8.0)
    with use_mesh_rules(mesh, rules_for(cfg, "train")):
        out["ep_stats"] = np.asarray(json.dumps(hlo_analysis.collective_bytes(
            moe.moe_apply, params, xt, cfg, num["exact"]).by_kind))

    # the hierarchical gradient reduce
    pod = make_test_mesh((2, 2), ("pod", "data"), device="cpu")
    tg = {k: torch.as_tensor(v) for k, v in g.items()}
    te = {k: torch.as_tensor(v) for k, v in e.items()}
    plain, _ = hierarchical_grad_reduce(pod, tg)
    comp, errs = hierarchical_grad_reduce(pod, tg, te, compress=True)
    # each rank's own gradients: rank r adds (r + 1) * delta
    delta = {k: torch.full_like(v, 1e-3) * torch.arange(
        v.numel()).reshape(v.shape) / v.numel() for k, v in tg.items()}
    own = {k: v + (rank + 1) * delta[k] for k, v in tg.items()}
    own_plain, _ = hierarchical_grad_reduce(pod, own)
    own_comp, own_errs = counted("multipod", lambda: hierarchical_grad_reduce(
        pod, own, te, compress=True))
    for k in g:
        out[f"mp_plain_{k}"] = plain[k].numpy()
        out[f"mp_comp_{k}"] = comp[k].numpy()
        out[f"mp_err_{k}"] = errs[k].numpy()
        out[f"own_{k}"] = own[k].numpy()
        out[f"own_plain_{k}"] = own_plain[k].numpy()
        out[f"own_comp_{k}"] = own_comp[k].numpy()
        out[f"own_err_{k}"] = own_errs[k].numpy()

    # the pipeline: 4 stages, 6 microbatches, a segmented3 stage
    pipe = make_test_mesh((WORLD,), ("pipe",), device="cpu")

    def stage(p, h):
        return torch.tanh(nmatmul(h, p["w"]))

    with numerics_scope(num["segmented3"]):
        out["pipe"] = counted("pipe", lambda: pipeline_apply(
            pipe, stage, {"w": torch.as_tensor(w)},
            torch.as_tensor(xs))).numpy()
    out["counts"] = np.asarray(json.dumps(counts))
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **out)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(jax_ref, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    ref_path = tmp / "ref.npz"
    np.savez(ref_path, **{k: v for k, v in jax_ref.items()
                          if k.startswith("param_")})
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, str(tmp / "store"), str(ref_path), str(tmp)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_S)
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
    assert not hung, f"{len(hung)} ranks did not finish in {JOIN_S} s"
    assert [p.exitcode for p in procs] == [0] * WORLD
    out = []
    for r in range(WORLD):
        got = dict(np.load(tmp / f"rank{r}.npz"))
        got["counts"] = json.loads(str(got["counts"]))
        got["ep_stats"] = json.loads(str(got["ep_stats"]))
        out.append(got)
    return out


def _ulps(got, want):
    return float(np.max(np.abs(got - want))
                 / np.spacing(np.float32(np.max(np.abs(want)))))


# ---------------------------------------------------------------------------
# the mesh and the collectives
# ---------------------------------------------------------------------------

def test_mesh_lays_ranks_row_major(ranks):
    for r, got in enumerate(ranks):
        d, m = divmod(r, 2)
        assert got["coords"].tolist() == [d, m]
        assert got["members_data"].tolist() == [m, 2 + m]
        assert got["members_model"].tolist() == [2 * d, 2 * d + 1]
        assert got["members_data_model"].tolist() == [0, 1, 2, 3]
        # a tuple of axes orders its ranks row-major over the tuple
        assert got["members_model_data"].tolist() == [0, 2, 1, 3]
        assert int(got["index_data_model"]) == r
        assert int(got["index_model_data"]) == 2 * m + d
        assert int(got["half"]) == (r if r < 2 else -1)


@pytest.mark.parametrize("axes", ["data", "model", "data_model",
                                  "model_data"])
def test_all_to_all_psum_pmean_follow_lax(ranks, axes):
    blocks = [np.arange(24, dtype=np.float32).reshape(4, 3, 2) + 100 * r
              for r in range(WORLD)]
    for r, got in enumerate(ranks):
        members = got[f"members_{axes}"].tolist()
        n, j = len(members), members.index(r)
        # lax.all_to_all(tiled): chunk j of every member, concatenated
        # along dim 1 in member order
        want = np.concatenate([np.split(blocks[s], n, axis=0)[j]
                               for s in members], axis=1)
        np.testing.assert_array_equal(got[f"a2a_{axes}"], want)
        total = sum(blocks[s] for s in members)
        np.testing.assert_array_equal(got[f"psum_{axes}"], total)
        np.testing.assert_allclose(got[f"pmean_{axes}"], total / n,
                                   rtol=1e-6)


def test_broadcast_and_ppermute(ranks):
    for r, got in enumerate(ranks):
        assert got["bcast"].tolist() == [2.0] * 3
        # (0, 1) along model: rank (d, 1) gets (d, 0)'s, the rest zeros
        want = [float(r - 1)] * 2 if r % 2 else [0.0, 0.0]
        assert got["perm"].tolist() == want


@pytest.mark.parametrize("spec", ["rep", "dm", "md0", "m2"])
def test_shard_map_round_trips(ranks, spec):
    full = np.random.default_rng(1).standard_normal((4, 6, 8)).astype(
        np.float32)
    shards = {"rep": (1, 1, 1), "dm": (2, 2, 1), "md0": (4, 1, 1),
              "m2": (1, 1, 2)}[spec]
    for got in ranks:
        np.testing.assert_array_equal(got[f"rt_{spec}"], 2 * full)
        # d(sum(2 t * full))/dt, whole on every rank: the ranks that hold
        # one block each give 1 / reps of its cotangent, summed
        np.testing.assert_allclose(got[f"rt_grad_{spec}"], 2 * full,
                                   rtol=1e-6)
        assert got[f"rt_local_{spec}"].tolist() == [
            d // s for d, s in zip(full.shape, shards)]


def test_collectives_differentiate_as_the_single_program(ranks):
    """Through shard_map, each gradient is the one JAX gives (as its
    check_rep=False shard_map transposes) for L = sum(y * (1, 2, ...))."""
    c = lambda n: np.arange(1, n + 1, dtype=np.float32)
    want = {
        # y = the four blocks of 2 summed
        "psum": np.tile(c(2), 4),
        "pmean": np.tile(c(2), 4) / 4,
        # y = rank 2's block, everywhere
        "bcast": np.concatenate([np.zeros(4), c(2), np.zeros(2)]),
        # y = the two halves swapped
        "perm": np.concatenate([c(8)[4:], c(8)[:4]]),
    }
    for got in ranks:
        for tag, w in want.items():
            np.testing.assert_allclose(got[f"dgrad_{tag}"], w, rtol=1e-6)


# ---------------------------------------------------------------------------
# expert-parallel MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf", CFS)
def test_ep_routing_matches_jax_per_shard(ranks, jax_ref, cf):
    for got in ranks:
        d = got["coords"][0]
        np.testing.assert_array_equal(got[f"eidx_{cf}"],
                                      jax_ref[f"eidx_{cf}_{d}"])
        np.testing.assert_array_equal(got[f"keep_{cf}"],
                                      jax_ref[f"keep_{cf}_{d}"])
    if cf == 1.0:   # capacity 8 for 32 tokens x 2 over 8 experts: drops
        assert not all(got["keep_1.0"].all() for got in ranks)


@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("mode", MODES)
def test_ep_outputs_match_jax(ranks, jax_ref, mode, cf):
    want = jax_ref[f"ep_{mode}_{cf}"]
    for got in ranks:
        y = got[f"ep_{mode}_{cf}"]
        assert y.shape == (B, S, D) and np.isfinite(y).all()
        if mode == "exact":
            np.testing.assert_allclose(y, want, rtol=EXACT_BOUND,
                                       atol=EXACT_BOUND)
        else:
            assert _ulps(y, want) <= ULPS
        np.testing.assert_array_equal(y, ranks[0][f"ep_{mode}_{cf}"])
        # the expert-parallel path ran: two exchanges of (E, C, D)
        C = _capacity(T_LOC, cf)
        assert got["counts"][f"ep_{mode}_{cf}"]["counted"]["all-to-all"] \
            == 2 * E * C * D * 4


def test_ep_gradients_match_jax(ranks, jax_ref):
    for got in ranks:
        for k in ("router", "wi", "wg", "wo"):
            a, b = got[f"grad_{k}"], jax_ref[f"grad_{k}"]
            assert np.isfinite(a).all()
            np.testing.assert_allclose(a, b, rtol=GRAD_BOUND,
                                       atol=GRAD_BOUND)


def test_heterogeneous_policy_falls_back_to_group_local(ranks, jax_ref):
    for got in ranks:
        np.testing.assert_allclose(got["hetero"], jax_ref["hetero"],
                                   rtol=EXACT_BOUND, atol=EXACT_BOUND)
        assert got["counts"]["hetero"]["counted"] == {}


@pytest.mark.parametrize("tag", ["ep_exact_8.0", "ep_segmented3_1.0", "grad",
                                 "multipod", "pipe"])
def test_counted_bytes_equal_what_the_ranks_received(ranks, tag):
    for got in ranks:
        c = got["counts"][tag]
        assert c["counted"] == c["received"] and c["counted"]


@pytest.mark.parametrize("cf", CFS)
def test_collective_bytes_against_the_reference_count(ranks, jax_ref, cf):
    """An exchange leaves each rank (E / nm, C * nm, D): E C D x 4 bytes,
    two exchanges a forward.  The reference's parser reads the CPU
    module's all-to-all as a tuple of nm = 2 operands of (E / nm, C, D)
    and sums both: the same output bytes, the rank's own chunk included
    (over the wire it gets the other nm - 1 chunks, half of them here)."""
    exchange = E * _capacity(T_LOC, cf) * D * 4
    for mode in MODES:
        assert jax_ref["coll"][f"ep_{mode}_{cf}"] == {
            "all-to-all": 2 * exchange}
        # the port also gathers the output (the reference's stays sharded)
        assert ranks[0]["counts"][f"ep_{mode}_{cf}"]["counted"] == {
            "all-to-all": 2 * exchange, "all-gather": B * S * D * 4}
    if cf == 8.0:
        assert ranks[0]["ep_stats"]["all-to-all"] == 2 * exchange
        # backward, the inverse of the return exchange only: no gradient
        # is taken for the tokens in the dispatch buffer, in both packages
        assert jax_ref["coll"]["grad"]["all-to-all"] == 3 * exchange
        assert ranks[0]["counts"]["grad"]["counted"]["all-to-all"] \
            == 3 * exchange


# ---------------------------------------------------------------------------
# the pipeline and the gradient reduce
# ---------------------------------------------------------------------------

def test_pipeline_matches_the_stages_in_sequence(ranks, jax_ref):
    from repro_torch.distributed.pipeline import bubble_fraction

    for got in ranks:
        np.testing.assert_allclose(got["pipe"], jax_ref["pipe_want"],
                                   rtol=PIPE_BOUND, atol=PIPE_BOUND)
        np.testing.assert_array_equal(got["pipe"], ranks[0]["pipe"])
    assert bubble_fraction(2, 3) == pytest.approx(1 / 4)
    # the reference's own pipeline_apply refuses S >= 2 (ROADMAP.md)
    assert "ppermute sources and destinations must be unique" in str(
        jax_ref["pipe_fault"])


@pytest.mark.parametrize("what", ["plain", "comp", "err"])
def test_multipod_matches_jax_on_equal_inputs(ranks, jax_ref, what):
    for got in ranks:
        for k in ("w", "b"):
            np.testing.assert_allclose(got[f"mp_{what}_{k}"],
                                       jax_ref[f"mp_{what}_{k}"],
                                       rtol=1e-6, atol=1e-7)


def _int8_np(g):
    """compress_with_feedback's blockwise int8 in numpy: (the
    reconstruction, each element's step)."""
    flat = g.reshape(-1)
    blocks = np.pad(flat, (0, -flat.size % 256)).reshape(-1, 256)
    scale = np.abs(blocks).max(1, keepdims=True) / np.float32(127.0)
    q = np.clip(np.round(blocks / np.maximum(scale, np.float32(1e-12))),
                -127, 127)
    return ((q * scale).reshape(-1)[:flat.size],
            np.repeat(scale[:, 0], 256)[:flat.size])


def test_multipod_on_each_ranks_own_gradients(ranks):
    """Ranks (pod, data): the mean over data, int8 with error feedback,
    the mean over pod, against numpy."""
    _, _, e, _, _ = _inputs()
    for k in ("w", "b"):
        own = np.stack([got[f"own_{k}"] for got in ranks])
        for got in ranks:
            np.testing.assert_allclose(got[f"own_plain_{k}"],
                                       own.astype(np.float64).mean(0),
                                       rtol=1e-6)
        per_pod = [((own[2 * p] + own[2 * p + 1]) / np.float32(2)
                    + e[k]).reshape(-1) for p in range(2)]
        recon = [_int8_np(g) for g in per_pod]
        step = np.maximum(recon[0][1], recon[1][1])
        for r, got in enumerate(ranks):
            comp = got[f"own_comp_{k}"].reshape(-1)
            np.testing.assert_allclose(comp, (recon[0][0] + recon[1][0]) / 2,
                                       rtol=0, atol=1e-6)
            assert np.all(np.abs(comp - (per_pod[0] + per_pod[1]) / 2)
                          <= step)
            # the new error feedback is what this pod's int8 lost
            np.testing.assert_allclose(got[f"own_err_{k}"].reshape(-1),
                                       per_pod[r // 2] - recon[r // 2][0],
                                       rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------

@pytest.fixture
def one_rank(tmp_path):
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_ranks

    init_ranks("cpu", init_method=f"file://{tmp_path}/store")
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_make_test_mesh_needs_enough_ranks(one_rank):
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed.sharding import P
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.multipod import hierarchical_grad_reduce
    from repro_torch.optim.compression import compress_with_feedback

    with pytest.raises(RuntimeError, match="need 4 devices, have 1"):
        make_test_mesh((2, 2), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_test_mesh((1, 1))           # cuda unless asked, and no card
    mesh = make_test_mesh((1, 1), device="cpu")
    assert mesh.has_ranks and mesh.coords == {"data": 0, "model": 0}
    x = torch.arange(6.0).reshape(2, 3)
    with col.count_collectives() as stats:
        y = col.shard_map(lambda t: col.all_to_all(t, mesh, "model", 0, 1),
                          mesh, (P("data"),), P("data"))(x)
    assert torch.equal(y, x)
    assert stats.by_kind == {"all-to-all": 24, "all-gather": 24}
    # one pod: the compressed reduce starts its error feedback at zeros
    pod = make_test_mesh((1, 1), ("pod", "data"), device="cpu")
    g = {"w": torch.linspace(-1.0, 1.0, 300)}
    got, errs = hierarchical_grad_reduce(pod, g, compress=True)
    want, want_errs = compress_with_feedback(g["w"], torch.zeros(300))
    assert torch.equal(got["w"], want) and torch.equal(errs["w"], want_errs)


def test_init_ranks_needs_a_shared_store_for_several_ranks():
    from repro_torch.launch.mesh import init_ranks

    with pytest.raises(ValueError, match="init_method"):
        init_ranks("cpu", rank=0, world_size=2)


def test_an_abstract_mesh_keeps_moe_group_local():
    """The dry-run's meshes hold no ranks: MoE stays group-local under
    their rules, and runs no collective."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed.sharding import rules_for, use_mesh_rules
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import moe

    cfg = _small_cfg(get_arch("deepseek-v3-671b").reduced(), 8.0)
    rng = np.random.default_rng(3)
    params = {k: torch.as_tensor(rng.standard_normal(s).astype(np.float32))
              for k, s in (("router", (D, E)), ("wi", (E, D, FF)),
                           ("wg", (E, D, FF)), ("wo", (E, FF, D)))}
    x = torch.as_tensor(rng.standard_normal((B, S, D)).astype(np.float32))
    want = moe.moe_apply(params, x, cfg)
    with use_mesh_rules(make_production_mesh(), rules_for(cfg, "train")):
        with col.count_collectives() as stats:
            got = moe.moe_apply(params, x, cfg)
    assert torch.equal(got, want) and stats.by_kind == {}


def test_roofline_terms_with_and_without_collective_stats():
    from repro_torch.distributed.collectives import CollectiveStats
    from repro_torch.launch import hlo_analysis

    cost = {"flops": 2e12, "bytes_stream": 5e10, "bytes_fused": 1e10}
    none = hlo_analysis.roofline_terms(cost, 4)
    assert none["t_collective_s"] is None and none["dominant"] == "memory"
    assert none["collective_bytes_per_chip"] is None
    assert none["collective_by_kind"] is None
    stats = CollectiveStats({"all-to-all": 4e9, "all-gather": 5e8})
    got = hlo_analysis.roofline_terms(cost, 4, coll=stats, model_flops=8e12)
    assert got["collective_bytes_per_chip"] == 4.5e9
    assert got["collective_by_kind"] == {"all-to-all": 4e9,
                                         "all-gather": 5e8}
    assert got["t_collective_s"] == 4.5e9 / 450e9
    assert got["dominant"] == "collective"
    assert got["roofline_fraction"] == (8e12 / 4 / 989e12) / (4.5e9 / 450e9)
    assert {k: v for k, v in got.items() if not k.startswith(
        ("collective", "t_collective", "dominant", "model", "useful",
         "roofline"))} == {k: v for k, v in none.items()
                           if not k.startswith(("collective", "t_collective",
                                                "dominant"))}


if __name__ == "__main__":
    _jax_reference(sys.argv[1])
