"""Whole-model placement: the port's steps run as DTensors under the
sharding rules, against the JAX package's sharded steps.

- The JAX side runs once, in a subprocess with 4 forced host devices (the
  file runs itself as that script): the body of
  ``src/repro/launch/dryrun.py``'s ``lower_session_cell`` on a (2, 2)
  ``("data", "model")`` mesh, jitted with ``in_shardings`` from
  ``tree_shardings`` and executed.  Cells: reduced qwen3-4b (a prefill at
  B 2, S 64 into a cache of 72, then one decode step at position 64,
  under exact and segmented3), reduced mamba2-130m and reduced
  deepseek-v3 prefills under segmented3, and a train cell (reduced
  qwen3-4b with the full config's training settings, ``TRAIN_SETTINGS``,
  at B 4, compiled only).  It writes the params, the logits, and
  ``memory_analysis()``, ``collective_bytes`` and ``loop_aware_cost``
  flops of the dry-run's own jits (a prefill into a cache of S, a decode
  step that donates its state, a train step that donates params and
  optimizer state).
- The port runs the same cells on 4 gloo ranks spawned on the CPU, the
  weights carried across by ``compat.params_from_numpy``: each step once
  unplaced and once on ``distributed.sharding.place``'d params and batch
  under ``use_mesh_rules``, its collectives counted; qwen3-4b's
  segmented3 cell once more with K1 through its custom op (the kernel
  route, whose CPU implementation is the plain version), its train
  step placed by the train rules against unplaced, the train cell's
  gradients placed against unplaced and its step's collectives, and
  reduced llama4's train step at grad_accum 2 (its micro-batches) placed
  against unplaced.  The
  ranks also hold each kernel op's sharding rules on CPU DTensors against
  the unsharded op.
- One more spawned process counts the same cells on meta tensors over a
  fake process group of CPU ranks (``launch.dryrun.lower_session_cell``
  of a CPU session, placed), and the 1 x 1 placed count against the
  unplaced one.  The collective bytes it counts are held against the
  gloo ranks', so this gate covers the count over CPU ranks; over CUDA
  ranks DTensor runs an all-to-all where gloo gathers and chunks, which
  ``tests/test_torch_dryrun.py`` counts on its own.
"""
import contextlib
import dataclasses
import json
import multiprocessing
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
B, S, MAX_LEN = 2, 64, 72
# (arch, numerics, with a decode step)
CELLS = (("qwen3-4b", "exact", True), ("qwen3-4b", "segmented3", True),
         ("mamba2-130m", "segmented3", False),
         ("deepseek-v3-671b", "segmented3", False))
ARCHS = tuple(dict.fromkeys(a for a, _, _ in CELLS))
# logits against JAX's sharded step, in units of the largest |logit|: the
# bound each arch's unsharded test holds (tests/test_torch_model.py,
# test_torch_ssm.py, test_torch_mla.py)
JAX_BOUND = {("qwen3-4b", "exact"): 1e-4,
             ("qwen3-4b", "segmented3"): 2.0 ** -8,
             ("mamba2-130m", "segmented3"): 2.0 ** -8,
             ("deepseek-v3-671b", "segmented3"): 2.0 ** -8}
# the placed step against the port's unplaced step: the same products,
# partial sums of a sharded contraction added in another order where
# they sum in fp32 (a training step, K1's op route, the LM head).  A
# serving step's products on the plain route sum in fp64, exactly
# (core.scope.fp64_sums, kernels.dispatch.matmul), so its backbone is the
# unplaced one's bit for bit, and its logits differ by where the head's
# partial sums are rounded
PLACED_BOUND = 1e-4
ULPS = 64
# one chip's temp bytes of the placed count over JAX's memory_analysis()
# temp at the same cell: at most XLA's (its buffer assignment holds what
# the eager count holds live, and more), at least half of it.  Pinned
# where the plans differ (ROADMAP.md section 3, deliberate differences):
# in the decode cells XLA's CPU backend holds fp32 copies of the bf16
# weights (and, under segmented3, of their hi/lo splits) across the layer
# loop, 163,840 of the exact cell's 230,584 temp bytes; the port converts
# one product's operands at a time.
TEMP_BOUND = (0.5, 1.0)
TEMP_RATIO = {"qwen3-4b/exact/decode": 64688 / 230584,
              "qwen3-4b/segmented3/decode": 64688 / 344952}
# per-chip FLOPs of the placed count over JAX's per-device loop_aware_cost
# where the two partition a product differently (ROADMAP.md section 3,
# deliberate differences); 1.0 where they agree.  mamba2: the SSD scan's
# C·Bᵀ of each chunk (Q x Q, the same for every head): GSPMD contracts it
# over the state dim N, which in_proj's output leaves sharded over
# 'model', and all-reduces the partial sums; the port's scan runs each
# rank's heads with B and C whole, as K3 takes them, and forms C·Bᵀ whole
# on both ranks of 'model': 8 products of 2 x 16 x 16 x 8 FLOPs more,
# 32,768.  Kept: a scan of B and C cut on N gives partial outputs, whose
# sum is not the whole scan bit for bit
# (test_scan_cut_on_the_state_dim_is_not_the_scan_bit_for_bit)
FLOPS_RATIO = {"mamba2-130m/segmented3/prefill": 11747328 / 11714560}
# the train cell: reduced qwen3-4b with the full config's training
# settings (remat full, the sequence sharded on the residual stream, bf16
# activations, the loss in 2 batch chunks, each rank taking its share of
# each), exact numerics, a batch of TRAIN_B x S tokens, the train rules
TRAIN_B = 4
TRAIN_SETTINGS = dict(remat="full", seq_shard_activations=True,
                      dtype="bfloat16", loss_batch_chunks=2)
TRAIN_KEY = "qwen3-4b/exact/train"
# the micro-batch cell: reduced llama4 (MoE) at this grad_accum, B TRAIN_B
ACCUM = 2
JOIN_S = 300


def _tag(arch, mode):
    return f"{arch}/{mode}"


def _tokens(vocab):
    rng = np.random.default_rng(7)
    return (rng.integers(0, vocab, (B, S)).astype(np.int32),
            rng.integers(0, vocab, (B, 1)).astype(np.int32))


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}|"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _unflatten(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("|")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


# ---------------------------------------------------------------------------
# the JAX side (run as a script in a subprocess with 4 host devices)
# ---------------------------------------------------------------------------

def _jax_reference(out_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as JP

    from repro.configs import get_arch
    from repro.core.numerics import NumericsConfig
    from repro.distributed.sharding import (rules_for, tree_shardings,
                                            use_mesh_rules)
    from repro.launch import hlo_analysis, specs, steps
    from repro.launch.mesh import make_test_mesh
    from repro.models import transformer
    from repro.models.layers import unzip

    assert len(jax.devices()) == WORLD
    num = {"exact": NumericsConfig(mode="exact"),
           "segmented3": NumericsConfig(mode="segmented", seg_passes=3,
                                        backend="xla")}
    mesh = make_test_mesh((2, 2), ("data", "model"))
    out, rec = {}, {}

    def record(key, jitted, *args):
        compiled = jitted.lower(*args).compile()
        text = compiled.as_text()
        mem = compiled.memory_analysis()
        rec[key] = {
            "memory": {k: int(getattr(mem, f"{k}_size_in_bytes"))
                       for k in ("argument", "output", "alias", "temp")},
            "coll": hlo_analysis.collective_bytes(text).by_kind,
            "flops": hlo_analysis.loop_aware_cost(text)["flops"]}

    for arch in ARCHS:
        base = get_arch(arch).reduced()
        params32, pspecs = unzip(transformer.init(base, jax.random.PRNGKey(0)))
        for k, v in _flatten(params32).items():
            out[f"param/{arch}/{k}"] = v
        params = jax.tree.map(
            lambda a: a.astype(jnp.bfloat16)
            if jnp.issubdtype(a.dtype, jnp.floating) else a, params32)
        tokens, token = _tokens(base.vocab)
        for a, mode, decode in CELLS:
            if a != arch:
                continue
            tag = _tag(arch, mode)
            cfg = dataclasses.replace(base, numerics=num[mode])
            rules = rules_for(cfg, "serve")
            with use_mesh_rules(mesh, rules):
                param_sh = tree_shardings(pspecs, params, mesh, rules)
                batch = {"tokens": jnp.asarray(tokens)}
                batch_sh = tree_shardings(specs.batch_axes_tree(batch), batch,
                                          mesh, rules)
                pre = jax.jit(steps.make_prefill_step(cfg, max_len=MAX_LEN),
                              in_shardings=(param_sh, batch_sh))
                logits, state = pre(params, batch)
                out[f"{tag}/prefill"] = np.asarray(logits, np.float32)
                # the dry-run's prefill cell: a cache of S
                record(f"{tag}/prefill", jax.jit(
                    steps.make_prefill_step(cfg, max_len=S),
                    in_shardings=(param_sh, batch_sh)), params, batch)
                if decode:
                    st_sh = tree_shardings(specs.state_axes_tree(state),
                                           state, mesh, rules)
                    dec_sh = (param_sh, st_sh,
                              NamedSharding(mesh, JP("data", None)),
                              NamedSharding(mesh, JP()))
                    dec = jax.jit(steps.make_decode_step(cfg),
                                  in_shardings=dec_sh)
                    # the state laid out as the decode step takes it
                    state = jax.device_put(state, st_sh)
                    args = (params, state, jnp.asarray(token), jnp.int32(S))
                    # the dry-run's decode cell donates the state, which
                    # the step then updates in place (compiled only)
                    record(f"{tag}/decode", jax.jit(
                        steps.make_decode_step(cfg), in_shardings=dec_sh,
                        donate_argnums=(1,)), *args)
                    logits, _ = dec(*args)
                    out[f"{tag}/decode"] = np.asarray(logits, np.float32)
    # the train cell: the dry-run's train kind (lower_session_cell), fp32
    # params and AdamW state donated, compiled only
    cfg = dataclasses.replace(get_arch("qwen3-4b").reduced(),
                              numerics=num["exact"], **TRAIN_SETTINGS)
    rules = rules_for(cfg, "train")
    with use_mesh_rules(mesh, rules):
        params_abs, pspecs = specs.abstract_params(cfg, dtype=jnp.float32)
        opt_cfg, opt_init, opt_apply, opt_specs = steps.make_optimizer(cfg)
        opt_abs = jax.eval_shape(lambda p: opt_init(p, opt_cfg), params_abs)
        batch = {k: specs.SDS((TRAIN_B, S), jnp.int32)
                 for k in ("tokens", "targets")}
        record(TRAIN_KEY, jax.jit(
            steps.make_train_step(cfg, opt_cfg, opt_apply),
            in_shardings=(tree_shardings(pspecs, params_abs, mesh, rules),
                          tree_shardings(opt_specs(pspecs), opt_abs, mesh,
                                         rules),
                          tree_shardings(specs.batch_axes_tree(batch), batch,
                                         mesh, rules)),
            donate_argnums=(0, 1)), params_abs, opt_abs, batch)
    out["rec"] = np.asarray(json.dumps(rec))
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, __file__, str(path)], env=env,
                          capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ref = dict(np.load(path))
    ref["rec"] = json.loads(str(ref["rec"]))
    return ref, path


# ---------------------------------------------------------------------------
# the port on 4 gloo ranks, and its counts over a fake group
# ---------------------------------------------------------------------------

def _port_numerics(mode):
    from repro_torch.core.numerics import NumericsConfig

    return (NumericsConfig(mode="exact") if mode == "exact" else
            NumericsConfig(mode="segmented", seg_passes=3))


def _rule_cases():
    """(name, op, full inputs, specs, extra args, exact): each kernel op
    on DTensors laid out by ``specs`` over the (2, 2) mesh."""
    import torch

    from repro_torch.core.afpm import AFPMConfig
    from repro_torch.distributed.sharding import P
    from repro_torch.kernels import custom_ops

    rng = np.random.default_rng(3)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32))

    x, w = t(4, 8, 1024), t(1024, 48, scale=0.05)
    ex, ew = t(4, 6, 128), t(128, 24, scale=0.1)
    ea, eb = t(8, 16), t(8, 16)
    L, H = 32, 4
    scan = (t(4, L, H, 8), torch.from_numpy(rng.uniform(
        0.01, 0.2, (4, L, H)).astype(np.float32)), -torch.from_numpy(
        rng.uniform(0.5, 2.0, (H,)).astype(np.float32)), t(4, L, 16),
        t(4, L, 16))
    cfg = AFPMConfig()

    def k1(a, b):
        return custom_ops.segmented_matmul(a, b, 3)

    def emu(a, b):
        return custom_ops.emulated_matmul(a, b, cfg, 16)

    def bitwise(a, b):
        return custom_ops.bitwise(a, b, cfg)

    def k3(*ins):
        return custom_ops.ssd(*ins, 8)

    mm = {"batch": (P("data"), P()), "rows": (P(None, "model"), P()),
          "cols": (P(), P(None, "model")),
          "batch_cols": (P("data"), P(None, "model")),
          "k": (P(None, None, "model"), P("model"))}
    cases = []
    for name, sp in mm.items():
        cases.append((f"k1_{name}", k1, (x, w), sp, name != "k"))
        cases.append((f"emulated_{name}", emu, (ex, ew), sp, name != "k"))
    cases.append(("bitwise", bitwise, (ea, eb),
                  (P("data", "model"), P("data", "model")), True))
    cases.append(("ssd_batch", k3, scan,
                  (P("data"), P("data"), P(), P("data"), P("data")), True))
    cases.append(("ssd_heads", k3, scan,
                  (P(None, None, "model"), P(None, None, "model"), P("model"),
                   P(), P()), True))
    return cases


RULE_CASES = ("k1_batch", "emulated_batch", "k1_rows", "emulated_rows",
              "k1_cols", "emulated_cols", "k1_batch_cols",
              "emulated_batch_cols", "k1_k", "emulated_k", "bitwise",
              "ssd_batch", "ssd_heads")


def _rank_main(rank, store, ref_path, out_dir):
    import torch

    torch.set_num_threads(1)
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch import tree as tree_util
    from repro_torch.compat import params_from_numpy
    from repro_torch.configs import get_arch
    from repro_torch.distributed.collectives import count_collectives
    from repro_torch.distributed.sharding import (place, place_tensor,
                                                  rules_for, use_mesh_rules)
    from repro_torch.kernels import dispatch
    from repro_torch.launch import specs, steps
    from repro_torch.launch.mesh import init_ranks, make_test_mesh
    from repro_torch.models import transformer

    init_ranks("cpu", rank, WORLD, f"file://{store}")
    mesh = make_test_mesh((2, 2), ("data", "model"), device="cpu")
    ref = np.load(ref_path)
    out, counts, rules_out = {}, {}, {}
    real_logits_fn = transformer.logits_fn

    @contextlib.contextmanager
    def head_input(key):
        # the LM head's input (the final norm's output, last position),
        # gathered on leaving: outside a collective count it encloses
        seen = []

        def logits_fn(p, c, h):
            seen.append(h.detach())
            return real_logits_fn(p, c, h)

        transformer.logits_fn = logits_fn
        try:
            yield
        finally:
            transformer.logits_fn = real_logits_fn
        h, = seen
        out[key] = (h.full_tensor() if isinstance(h, DTensor) else h
                    ).float().numpy()

    def run(cfg, params, tokens, token, decode, tag):
        rules = rules_for(cfg, "serve")
        pspecs = transformer.unflatten(transformer.param_specs(cfg))
        pre = steps.make_prefill_step(cfg, max_len=MAX_LEN)
        dec = steps.make_decode_step(cfg)
        batch = {"tokens": torch.from_numpy(tokens)}
        with use_mesh_rules(mesh, rules):
            pp = place(params, pspecs, mesh, rules)
            bb = place(batch, specs.batch_axes_tree(batch), mesh, rules)
            with head_input(f"{tag}/prefill_hidden"):
                logits, state = pre(pp, bb)
            assert isinstance(logits, DTensor)
            out[f"{tag}/prefill"] = logits.full_tensor().float().numpy()
            # the collectives of the dry-run's prefill cell (a cache of S)
            with count_collectives() as stats:
                steps.make_prefill_step(cfg, max_len=S)(pp, bb)
            counts[f"{tag}/prefill"] = dict(stats.by_kind)
            if decode:
                tok = place(torch.from_numpy(token), specs.BATCH_AXES["token"],
                            mesh, rules)
                with head_input(f"{tag}/decode_hidden"), \
                        count_collectives() as stats:
                    logits, _ = dec(pp, state, tok, S)
                out[f"{tag}/decode"] = logits.full_tensor().float().numpy()
                counts[f"{tag}/decode"] = dict(stats.by_kind)

    for arch in ARCHS:
        base = get_arch(arch).reduced()
        prefix = f"param/{arch}/"
        tree = _unflatten({k[len(prefix):]: ref[k] for k in ref.files
                           if k.startswith(prefix)})
        params32 = params_from_numpy(tree, base, "cpu")
        params = tree_util.map(
            lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t,
            params32)
        tokens, token = _tokens(base.vocab)
        for a, mode, decode in CELLS:
            if a != arch:
                continue
            tag = _tag(arch, mode)
            cfg = dataclasses.replace(base, numerics=_port_numerics(mode))
            pre = steps.make_prefill_step(cfg, max_len=MAX_LEN)
            with head_input(f"{tag}/unplaced_prefill_hidden"):
                logits, state = pre(params,
                                    {"tokens": torch.from_numpy(tokens)})
            out[f"{tag}/unplaced_prefill"] = logits.float().numpy()
            if decode:
                with head_input(f"{tag}/unplaced_decode_hidden"):
                    logits, _ = steps.make_decode_step(cfg)(
                        params, state, torch.from_numpy(token), S)
                out[f"{tag}/unplaced_decode"] = logits.float().numpy()
            run(cfg, params, tokens, token, decode, f"placed/{tag}")
            if mode == "segmented3" and arch == "qwen3-4b":
                # the kernel route: K1 through its custom op, sharded by the
                # op's rules (its CPU implementation: the plain version)
                calls = []
                real = dispatch.custom_ops.segmented_matmul

                def counted(*args, **kwargs):
                    calls.append(1)
                    return real(*args, **kwargs)

                resolve = dispatch.resolve_backend
                dispatch.resolve_backend = lambda backend, x: "hopper"
                dispatch.custom_ops.segmented_matmul = counted
                try:
                    run(cfg, params, tokens, token, decode, f"ops/{tag}")
                finally:
                    dispatch.custom_ops.segmented_matmul = real
                    dispatch.resolve_backend = resolve
                out["ops_calls"] = np.asarray(len(calls))

    # each kernel op's rules on CPU DTensors against the unsharded op
    for name, op, ins, sp, exact in _rule_cases():
        want = op(*ins)
        placed = [place_tensor(t, s, mesh) for t, s in zip(ins, sp)]
        with count_collectives() as stats:
            got = op(*placed)
        rules_out[name] = {
            "sharded": any(p.is_shard() for p in got.placements),
            "partial": any(p.is_partial() for p in got.placements),
            "moved": dict(stats.by_kind), "exact": exact}
        out[f"rule/{name}/got"] = got.full_tensor().numpy()
        out[f"rule/{name}/want"] = want.numpy()

    # the train step under the train rules: reduced qwen3-4b, segmented3,
    # fp32 params (specs.abstract_params' dtype for a train cell)
    cfg = dataclasses.replace(get_arch("qwen3-4b").reduced(),
                              numerics=_port_numerics("segmented3"))
    prefix = "param/qwen3-4b/"
    tree = _unflatten({k[len(prefix):]: ref[k] for k in ref.files
                       if k.startswith(prefix)})
    tokens, _ = _tokens(cfg.vocab)
    batch = {"tokens": torch.from_numpy(tokens),
             "targets": torch.from_numpy(np.roll(tokens, -1, axis=1))}
    loss, grads = steps.grads_of(transformer.loss_fn,
                                 params_from_numpy(tree, cfg, "cpu"), cfg,
                                 batch)
    rules = rules_for(cfg, "train")
    pspecs = transformer.unflatten(transformer.param_specs(cfg))
    opt_cfg, opt_init, opt_apply = steps.make_optimizer(cfg)
    with use_mesh_rules(mesh, rules):
        pp = place(params_from_numpy(tree, cfg, "cpu"), pspecs, mesh, rules)
        bb = place(batch, specs.batch_axes_tree(batch), mesh, rules)
        ploss, pgrads = steps.grads_of(transformer.loss_fn, pp, cfg, bb)
        out["train_loss"] = np.asarray([float(loss),
                                        float(ploss.full_tensor())])
        out["train_grad_err"] = np.asarray(max(
            float((g.full_tensor() - w).abs().max() / w.abs().max())
            for g, w in zip(tree_util.leaves(pgrads),
                            tree_util.leaves(grads))))
        steps.clear_grads(pp)
        opt = opt_init(pp, opt_cfg)
        before = [t.full_tensor().clone() for t in tree_util.leaves(pp)]
        pp, opt, metrics = steps.make_train_step(cfg, opt_cfg, opt_apply)(
            pp, place(opt, specs.opt_state_specs(opt, pspecs), mesh, rules),
            bb)
        after = [t.full_tensor() for t in tree_util.leaves(pp)]
        out["train_step"] = np.asarray([
            float(metrics["loss"].full_tensor()),
            float(all(torch.isfinite(t).all() for t in after)),
            float(all(isinstance(t, DTensor) for t in tree_util.leaves(pp))),
            float(all(not torch.equal(a, b) for a, b in zip(after, before)
                      if a.numel() > 1))])
    # the train cell (TRAIN_SETTINGS): gradients placed against unplaced,
    # then the dry-run's step (make_train_step with AdamW) placed, its
    # collectives counted
    cfg = dataclasses.replace(get_arch("qwen3-4b").reduced(),
                              numerics=_port_numerics("exact"),
                              **TRAIN_SETTINGS)
    tokens = np.random.default_rng(17).integers(0, cfg.vocab, (TRAIN_B, S))
    batch = {"tokens": torch.from_numpy(tokens.astype(np.int32)),
             "targets": torch.from_numpy(np.roll(tokens, -1, 1)
                                         .astype(np.int32))}
    loss, grads = steps.grads_of(transformer.loss_fn,
                                 params_from_numpy(tree, cfg, "cpu"), cfg,
                                 batch)
    rules = rules_for(cfg, "train")
    opt_cfg, opt_init, opt_apply = steps.make_optimizer(cfg)
    with use_mesh_rules(mesh, rules):
        params = params_from_numpy(tree, cfg, "cpu")
        opt = place(opt_init(params, opt_cfg), specs.opt_state_specs(
            opt_init(params, opt_cfg), pspecs), mesh, rules)
        pp = place(params, pspecs, mesh, rules)
        bb = place(batch, specs.batch_axes_tree(batch), mesh, rules)
        ploss, pgrads = steps.grads_of(transformer.loss_fn, pp, cfg, bb)
        out["chunked_train_loss"] = np.asarray([float(loss),
                                                float(ploss.full_tensor())])
        out["chunked_train_grad_err"] = np.asarray([
            float((g.full_tensor() - w).abs().max() / w.abs().max())
            for g, w in zip(tree_util.leaves(pgrads), tree_util.leaves(grads))])
        steps.clear_grads(pp)
        with count_collectives() as stats:
            steps.make_train_step(cfg, opt_cfg, opt_apply)(pp, opt, bb)
        counts[f"placed/{TRAIN_KEY}"] = dict(stats.by_kind)
    # reduced llama4 (MoE) at grad_accum ACCUM, its rows holding different
    # numbers of valid targets: make_train_step placed against unplaced
    cfg = dataclasses.replace(get_arch("llama4-maverick-400b-a17b").reduced(),
                              grad_accum=ACCUM)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (TRAIN_B, S))
    targets = np.roll(tokens, -1, 1)
    for r in range(TRAIN_B):
        targets[r, S - 13 * r:] = -1
    batch = {"tokens": torch.from_numpy(tokens.astype(np.int32)),
             "targets": torch.from_numpy(targets.astype(np.int32))}
    opt_cfg, opt_init, opt_apply = steps.make_optimizer(cfg)
    params = transformer.init(cfg, seed=0, device="cpu")
    _, _, metrics = steps.make_train_step(cfg, opt_cfg, opt_apply)(
        params, opt_init(params, opt_cfg), batch)
    pspecs = transformer.unflatten(transformer.param_specs(cfg))
    rules = rules_for(cfg, "train")
    with use_mesh_rules(mesh, rules):
        params = transformer.init(cfg, seed=0, device="cpu")
        opt = opt_init(params, opt_cfg)
        opt = place(opt, specs.opt_state_specs(opt, pspecs), mesh, rules)
        pp = place(params, pspecs, mesh, rules)
        bb = place(batch, specs.batch_axes_tree(batch), mesh, rules)
        _, _, placed = steps.make_train_step(cfg, opt_cfg, opt_apply)(
            pp, opt, bb)
    out["accum_train"] = np.asarray([
        float(v.full_tensor() if isinstance(v, DTensor) else v)
        for m in (metrics, placed) for v in (m["loss"], m["grad_norm"])])
    out["counts"] = np.asarray(json.dumps(counts))
    out["rules"] = np.asarray(json.dumps(rules_out))
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **out)
    dist.destroy_process_group()


def _count_main(out_path):
    """The dry-run's counts of the same cells: sharded over a fake group
    of (2, 2), and on one chip placed and not."""
    import torch

    torch.set_num_threads(1)
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    from repro_torch.session import Session

    res = {}
    mesh = Mesh((2, 2), ("data", "model"))
    for arch, mode, decode in CELLS:
        sess = Session(arch, policy=mode, device="cpu")
        shapes = {"prefill": dict(kind="prefill", seq=S, batch=B)}
        if decode:
            shapes["decode"] = dict(kind="decode", seq=MAX_LEN, batch=B)
        for phase, shape in shapes.items():
            # a CPU session's count: over CPU ranks, as the gloo ranks
            # run (DTensor gathers and chunks there for an all-to-all)
            rec = dryrun.lower_session_cell(sess, shape, mesh=mesh)
            res[f"{_tag(arch, mode)}/{phase}"] = {
                "coll": rec["roofline"]["collective_by_kind"],
                "flops": rec["roofline"]["hlo_flops_per_chip"],
                "memory": rec["memory"], "sharded": rec["sharded"]}
    cfg = dataclasses.replace(get_arch("qwen3-4b").reduced(),
                              numerics=_port_numerics("exact"),
                              **TRAIN_SETTINGS)
    rec = dryrun.lower_session_cell(Session(cfg, device="cpu"),
                                    dict(kind="train", seq=S, batch=TRAIN_B),
                                    mesh=mesh)
    res[TRAIN_KEY] = {"coll": rec["roofline"]["collective_by_kind"],
                      "flops": rec["roofline"]["hlo_flops_per_chip"],
                      "memory": rec["memory"], "sharded": rec["sharded"]}
    one = Mesh((1, 1), ("data", "model"))
    for arch in ("qwen3-4b", "mamba2-130m"):
        sess = Session(arch, policy="segmented3", device="cpu")
        for kind, seq in (("prefill", S), ("decode", MAX_LEN),
                          ("train", 16)):
            shape = dict(kind=kind, seq=seq, batch=B)
            got = [dryrun.lower_session_cell(sess, shape, mesh=one,
                                             place_one_chip=placed)
                   for placed in (True, False)]
            res[f"one/{arch}/{kind}"] = [
                {"flops": r["roofline"]["hlo_flops_per_chip"],
                 "stream": r["roofline"]["hlo_bytes_stream_per_chip"],
                 "coll": r["roofline"]["collective_by_kind"] or {},
                 **r["memory"]} for r in got]
    with open(out_path, "w") as f:
        json.dump(res, f)


@pytest.fixture(scope="module")
def ranks(jax_ref, tmp_path_factory):
    _, ref_path = jax_ref
    tmp = tmp_path_factory.mktemp("ranks")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, str(tmp / "store"), str(ref_path), str(tmp)))
             for r in range(WORLD)]
    procs.append(ctx.Process(target=_count_main,
                             args=(str(tmp / "count.json"),)))
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
    assert not hung, f"{len(hung)} processes did not finish in {JOIN_S} s"
    assert [p.exitcode for p in procs] == [0] * (WORLD + 1)
    out = []
    for r in range(WORLD):
        got = dict(np.load(tmp / f"rank{r}.npz"))
        got["counts"] = json.loads(str(got["counts"]))
        got["rules"] = json.loads(str(got["rules"]))
        out.append(got)
    with open(tmp / "count.json") as f:
        return out, json.load(f)


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


PHASES = [(a, m, ph) for a, m, d in CELLS
          for ph in (("prefill", "decode") if d else ("prefill",))]
IDS = [f"{a}-{m}-{ph}" for a, m, ph in PHASES]
# the counted cells: the serving phases and the train cell
COUNTED = PHASES + [tuple(TRAIN_KEY.split("/"))]
COUNTED_IDS = [f"{a}-{m}-{ph}" for a, m, ph in COUNTED]


# ---------------------------------------------------------------------------
# the placed steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,mode,phase", PHASES, ids=IDS)
def test_placed_logits_match_the_jax_sharded_step(ranks, jax_ref, arch, mode,
                                                  phase):
    ref, _ = jax_ref
    got = ranks[0][0][f"placed/{_tag(arch, mode)}/{phase}"]
    want = ref[f"{_tag(arch, mode)}/{phase}"]
    assert got.shape == want.shape and np.isfinite(got).all()
    assert _rel(got, want) <= JAX_BOUND[(arch, mode)]


@pytest.mark.parametrize("arch,mode,phase", PHASES, ids=IDS)
def test_placed_logits_match_the_unplaced_step(ranks, arch, mode, phase):
    rank0 = ranks[0][0]
    tag = _tag(arch, mode)
    want = rank0[f"{tag}/unplaced_{phase}"]
    for r in ranks[0]:   # every rank holds the same whole logits
        np.testing.assert_array_equal(r[f"placed/{tag}/{phase}"],
                                      rank0[f"placed/{tag}/{phase}"])
    assert _rel(rank0[f"placed/{tag}/{phase}"], want) <= PLACED_BOUND


@pytest.mark.parametrize("arch,mode,phase", PHASES, ids=IDS)
def test_placed_head_input_is_the_unplaced_one_bit_for_bit(ranks, arch, mode,
                                                           phase):
    """A serving step's products on the plain route sum in fp64 and round
    once after a placed product's partial sums are reduced
    (core.scope.fp64_sums, kernels.dispatch.matmul): every product, norm
    and attention sum
    before the LM head is then independent of how its contraction, rows
    or columns are split over the ranks, and the head's input (the final
    norm's output, which the head rounds to bf16) is the unplaced one's
    bit for bit on every rank."""
    tag = _tag(arch, mode)
    want = ranks[0][0][f"{tag}/unplaced_{phase}_hidden"]
    for r in ranks[0]:
        np.testing.assert_array_equal(r[f"placed/{tag}/{phase}_hidden"],
                                      want)


@pytest.mark.parametrize("arch,mode,phase", PHASES, ids=IDS)
def test_greedy_tokens_equal(ranks, jax_ref, arch, mode, phase):
    ref, _ = jax_ref
    tag = _tag(arch, mode)
    rank0 = ranks[0][0]
    placed = rank0[f"placed/{tag}/{phase}"].argmax(-1)
    np.testing.assert_array_equal(placed, rank0[f"{tag}/unplaced_{phase}"]
                                  .argmax(-1))
    np.testing.assert_array_equal(placed, ref[f"{tag}/{phase}"].argmax(-1))


@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_k1_route_through_its_op_matches_the_unplaced_step(ranks, phase):
    rank0 = ranks[0][0]
    tag = _tag("qwen3-4b", "segmented3")
    got = rank0[f"ops/{tag}/{phase}"]
    assert _rel(got, rank0[f"{tag}/unplaced_{phase}"]) <= PLACED_BOUND
    # 2 layers x 7 projections and the LM head a forward: the prefill, the
    # dry-run cell's prefill and the decode step
    assert int(rank0["ops_calls"]) == 3 * (2 * 7 + 1)


@pytest.mark.parametrize("name", RULE_CASES)
def test_each_op_rule_against_the_unsharded_op(ranks, name):
    for r in ranks[0]:
        rec = r["rules"][name]
        got, want = r[f"rule/{name}/got"], r[f"rule/{name}/want"]
        if rec["exact"]:
            # the op ran on each rank's block, nothing moved, bit for bit
            assert rec["moved"] == {}, rec
            assert rec["sharded"] and not rec["partial"], rec
            np.testing.assert_array_equal(got, want)
        else:
            # K sharded: partial sums, added in another order
            assert rec["partial"] and rec["moved"] == {}, rec
            ulp = np.spacing(np.float32(np.max(np.abs(want))))
            assert np.max(np.abs(got - want)) <= ULPS * ulp


def test_scan_cut_on_the_state_dim_is_not_the_scan_bit_for_bit():
    """Why the port's scan takes B and C whole where GSPMD contracts C·Bᵀ
    over the state dim N (``FLOPS_RATIO``): a scan is a sum over N, so the
    scans of B and C's two halves of N (the reduced mamba2-130m prefill's
    shapes at (2, 2): N 16 over 2 ranks) add up to it, but in another
    order of fp32 sums.  The sum stays within PLACED_BOUND of the largest
    output, the bound of a placed product whose partial sums add in
    another order; it is not the unplaced scan bit for bit, as every
    placed serving step of the port is."""
    import torch

    from repro_torch.kernels import ref

    rng = np.random.default_rng(0)
    b, L, H, P, N, Q = 2, 64, 16, 8, 16, 16

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    x, B, C = t(b, L, H, P), t(b, L, N), t(b, L, N)
    dt = torch.from_numpy(rng.uniform(0.01, 0.2, (b, L, H)).astype(np.float32))
    A = -torch.from_numpy(rng.uniform(0.5, 2.0, (H,)).astype(np.float32))
    whole = ref.ssd_scan_chunked_ref(x, dt, A, B, C, Q).numpy()
    h = N // 2
    parts = (ref.ssd_scan_chunked_ref(x, dt, A, B[..., :h], C[..., :h], Q)
             + ref.ssd_scan_chunked_ref(x, dt, A, B[..., h:], C[..., h:], Q)
             ).numpy()
    assert _rel(parts, whole) <= PLACED_BOUND
    assert np.count_nonzero(parts != whole) > whole.size // 2


def test_train_cell_moves_fewer_bytes_than_gspmd(ranks, jax_ref):
    """The train cell's column-parallel products (the LM head among them)
    on a sequence-sharded activation: the port gathers the sequence where
    XLA's partitioner gathers each weight at this size (ROADMAP.md section
    3, deliberate differences).  The same FLOPs a chip, and fewer
    collective bytes a chip in all than XLA's."""
    port = ranks[1][TRAIN_KEY]
    want = jax_ref[0]["rec"][TRAIN_KEY]
    assert port["flops"] == want["flops"]
    assert 0 < sum(port["coll"].values()) < sum(want["coll"].values())


# the gradients of the reference's train step (tests/test_torch_train.py's
# bounds): the placed loss and every leaf's gradient against unplaced
GRAD_BOUND, LOSS_RTOL = 2.0 ** -6, 1e-5


def test_placed_train_step_matches_the_unplaced_step(ranks):
    rank0 = ranks[0][0]
    loss, placed = rank0["train_loss"]
    assert placed == pytest.approx(loss, rel=LOSS_RTOL)
    assert float(rank0["train_grad_err"]) <= GRAD_BOUND
    step_loss, finite, still_placed, moved = rank0["train_step"]
    # make_train_step ran unchanged on the placed trees: the same loss,
    # every param updated in place, finite, still a DTensor
    assert step_loss == pytest.approx(loss, rel=LOSS_RTOL)
    assert finite == still_placed == moved == 1.0


def test_placed_train_step_in_chunks_matches_the_unplaced_step(ranks):
    """The train cell's settings on the gloo ranks: the sequence sharded,
    each block recomputed, the loss in batch chunks of each rank's own
    block (sharding.loss_pieces) and its gold logits taken from each rank's
    block (sharding.take_last): the loss and every leaf's gradient against
    the unplaced step's."""
    rank0 = ranks[0][0]
    loss, placed = rank0["chunked_train_loss"]
    assert placed == pytest.approx(loss, rel=LOSS_RTOL)
    errs = rank0["chunked_train_grad_err"]
    assert len(errs) > 10 and float(errs.max()) <= GRAD_BOUND


def test_placed_micro_batches_match_the_unplaced_step(ranks):
    """make_train_step at grad_accum 2 on reduced llama4 (MoE), the
    batch's rows holding 64, 51, 38 and 25 valid targets: each
    micro-batch's loss is a mean over its own rows, so the placed
    micro-batches must hold the unplaced step's rows, the reference's
    ``(accum, B / accum)`` cut (sharding.micro_batch): the loss and the
    gradient norm against unplaced."""
    loss, norm, placed_loss, placed_norm = ranks[0][0]["accum_train"]
    assert placed_loss == pytest.approx(loss, rel=LOSS_RTOL)
    assert placed_norm == pytest.approx(norm, rel=PLACED_BOUND)


# ---------------------------------------------------------------------------
# the sharded count
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,mode,phase", COUNTED, ids=COUNTED_IDS)
def test_fake_group_collectives_equal_what_the_gloo_ranks_counted(
        ranks, arch, mode, phase):
    key = f"{_tag(arch, mode)}/{phase}"
    counted = ranks[1][key]
    assert counted["sharded"] and counted["coll"]
    for r in ranks[0]:
        assert r["counts"][f"placed/{key}"] == counted["coll"]


@pytest.mark.parametrize("arch,mode,phase", COUNTED, ids=COUNTED_IDS)
def test_per_chip_flops_against_jax_loop_aware_cost(ranks, jax_ref, arch, mode,
                                                    phase):
    ref, _ = jax_ref
    key = f"{_tag(arch, mode)}/{phase}"
    got, want = ranks[1][key]["flops"], ref["rec"][key]["flops"]
    assert want > 0 and got / want == pytest.approx(
        FLOPS_RATIO.get(key, 1.0), rel=1e-12, abs=0), (got, want)


@pytest.mark.parametrize("arch,mode,phase", COUNTED, ids=COUNTED_IDS)
def test_sharded_peak_is_counted(ranks, jax_ref, arch, mode, phase):
    key = f"{_tag(arch, mode)}/{phase}"
    mem = ranks[1][key]["memory"]
    assert mem["temp_bytes"] > 0 and mem["peak_estimate_bytes"] == (
        mem["argument_bytes"] + mem["temp_bytes"] + mem["output_bytes"]
        - mem["alias_bytes"])
    # against JAX's per-device temp at the same cell
    ratio = mem["temp_bytes"] / jax_ref[0]["rec"][key]["memory"]["temp"]
    if key in TEMP_RATIO:
        assert ratio == pytest.approx(TEMP_RATIO[key], rel=1e-12, abs=0)
    else:
        assert TEMP_BOUND[0] <= ratio <= TEMP_BOUND[1], ratio


@pytest.mark.parametrize("arch", ["qwen3-4b", "mamba2-130m"])
@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_one_chip_sharded_count_equals_the_unsharded_count(ranks, arch, kind):
    sharded, plain = ranks[1][f"one/{arch}/{kind}"]
    assert sharded["coll"] == {}
    for k in ("flops", "stream", "argument_bytes", "output_bytes",
              "alias_bytes", "temp_bytes", "peak_estimate_bytes"):
        assert sharded[k] == plain[k], k


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_one_rank_placed_prefill_runs_k1_through_its_op():
    """On the card: a one-rank NCCL mesh, reduced qwen3-4b placed by the
    serve rules, segmented3: the same logits bit for bit and the same K1
    launches as unplaced."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K1 is a CUDA kernel")
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import place, rules_for, \
        use_mesh_rules
    from repro_torch.kernels import afpm_matmul as k1
    from repro_torch.launch import specs, steps
    from repro_torch.launch.mesh import init_ranks, make_test_mesh
    from repro_torch.models import transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_arch("qwen3-4b").reduced(),
                              numerics=_port_numerics("segmented3"))
    params = transformer.init(cfg, 0, "cuda")
    tokens, _ = _tokens(cfg.vocab)
    batch = {"tokens": torch.from_numpy(tokens).cuda()}
    pre = steps.make_prefill_step(cfg, max_len=MAX_LEN)
    before = k1.afpm_matmul.launches
    want, _ = pre(params, batch)
    n = k1.afpm_matmul.launches - before
    init_ranks("cuda")
    try:
        mesh = make_test_mesh((1, 1), ("data", "model"), device="cuda")
        rules = rules_for(cfg, "serve")
        with use_mesh_rules(mesh, rules):
            pp = place(params, transformer.unflatten(
                transformer.param_specs(cfg)), mesh, rules)
            bb = place(batch, specs.batch_axes_tree(batch), mesh, rules)
            before = k1.afpm_matmul.launches
            got, _ = pre(pp, bb)
            assert k1.afpm_matmul.launches - before == n > 0
        torch.testing.assert_close(got.full_tensor(), want, rtol=0, atol=0)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _jax_reference(sys.argv[1])
