"""The port's launch-layer host code against the JAX package: the
continuous-batching scheduler (``repro_torch.launch.scheduler``; the cases
of ``tests/test_scheduler.py``, and its tokens equal the JAX
``ContinuousBatcher``'s on the same weights) and the elastic coordinator
(``repro_torch.launch.elastic``; the cases of ``tests/test_elastic.py``),
and the abstract production meshes."""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.scheduler import ContinuousBatcher as JaxBatcher
from repro.launch.scheduler import Request as JaxRequest
from repro.session import Session as JaxSession
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.compat import params_from_numpy
from repro_torch.configs import get_arch
from repro_torch.distributed.fault import RestartPolicy
from repro_torch.launch import steps
from repro_torch.launch.elastic import ElasticCoordinator
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.launch.scheduler import ContinuousBatcher, Request
from repro_torch.models import transformer

FIXTURE = (pathlib.Path(__file__).resolve().parent / "golden" / "compat"
           / "qwen3-4b")


def _make_fns(cfg, params, max_len):
    prefill = steps.make_prefill_step(cfg, max_len=max_len)
    decode = steps.make_decode_step(cfg)
    return (lambda toks: prefill(params, {"tokens": toks}),
            lambda tok, st, pos: decode(params, st, tok, pos))


@pytest.fixture(scope="module")
def seeded():
    cfg = get_arch("qwen3-4b").reduced()
    return cfg, transformer.init(cfg, 0, "cpu")


# -- the scheduler: tests/test_scheduler.py's cases --------------------------

def test_scheduler_completes_all_requests(seeded):
    cfg, params = seeded
    max_len = 64
    b = ContinuousBatcher(2, *_make_fns(cfg, params, max_len), max_len,
                          device="cpu")
    rng = np.random.default_rng(0)
    for uid in range(5):  # more requests than slots: queuing happens
        b.submit(Request(uid=uid, prompt=rng.integers(0, cfg.vocab, 12),
                         max_new_tokens=4))
    done, ticks = b.run_to_completion()
    assert len(done) == 5
    assert all(len(r.generated) == 4 and r.done for r in done)
    assert ticks < 40
    assert b.utilization == 0.0  # drained


def test_scheduler_matches_unbatched_decode(seeded):
    """Tokens produced through the scheduler == a manual greedy loop."""
    cfg, params = seeded
    max_len = 48
    prefill_fn, decode_fn = _make_fns(cfg, params, max_len)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, 10)
    b = ContinuousBatcher(1, prefill_fn, decode_fn, max_len, device="cpu")
    b.submit(Request(uid=0, prompt=prompt, max_new_tokens=5))
    done, _ = b.run_to_completion()

    logits, state = prefill_fn(torch.as_tensor(prompt)[None])
    want = [int(logits[0, -1].argmax())]
    pos = len(prompt)
    for _ in range(4):
        lg, state = decode_fn(torch.tensor([[want[-1]]]), state, pos)
        want.append(int(lg[0, -1].argmax()))
        pos += 1
    assert done[0].generated == want


def test_scheduler_eos_early_stop(seeded):
    cfg, params = seeded
    prefill_fn, decode_fn = _make_fns(cfg, params, 48)
    b = ContinuousBatcher(1, prefill_fn, decode_fn, 48, device="cpu")
    prompt = np.arange(8) % cfg.vocab
    logits, _ = prefill_fn(torch.as_tensor(prompt)[None])
    first = int(logits[0, -1].argmax())
    b.submit(Request(uid=0, prompt=prompt, max_new_tokens=10, eos_id=first))
    done, _ = b.run_to_completion()
    assert done[0].generated == [first]  # stopped at eos immediately


def test_scheduler_refuses_the_cpu_unless_asked(seeded, monkeypatch):
    cfg, params = seeded
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousBatcher(1, *_make_fns(cfg, params, 16), 16)


@pytest.mark.parametrize("preset", ["exact", "segmented3"])
def test_scheduler_tokens_equal_the_jax_batchers(preset):
    """The committed qwen3-4b fixture's weights in both packages: the
    port's batcher emits the JAX batcher's tokens, request by request."""
    js = JaxSession.from_pretrained("qwen3-4b", FIXTURE).replace(policy=preset)
    cfg = js.config
    params = params_from_numpy(jax.tree.map(np.asarray, js.params),
                               get_arch("qwen3-4b").reduced(), "cpu")
    from repro_torch.session import Session

    tcfg = Session("qwen3-4b", preset, params=params, device="cpu").config
    max_len = 40
    jprefill = jax.jit(lambda p, b: jax_prefill(p, cfg, b, max_len))
    jdecode = jax.jit(lambda p, tok, st, pos: jax_decode(p, cfg, tok, st, pos))
    jb = JaxBatcher(
        2, lambda toks: jprefill(js.params, {"tokens": jnp.asarray(toks,
                                                                   jnp.int32)}),
        lambda tok, st, pos: jdecode(js.params, tok, st, pos), max_len)
    tb = ContinuousBatcher(2, *_make_fns(tcfg, params, max_len), max_len,
                           device="cpu")
    rng = np.random.default_rng(7)
    for uid in range(4):
        prompt = rng.integers(0, cfg.vocab, 6 + 3 * uid)
        jb.submit(JaxRequest(uid=uid, prompt=prompt, max_new_tokens=6))
        tb.submit(Request(uid=uid, prompt=prompt, max_new_tokens=6))
    jdone, jticks = jb.run_to_completion()
    tdone, tticks = tb.run_to_completion()
    assert jticks == tticks
    assert {r.uid: r.generated for r in tdone} == \
        {r.uid: r.generated for r in jdone}


def jax_prefill(p, cfg, b, max_len):
    from repro.models import transformer as jt

    return jt.prefill(p, cfg, b, max_len=max_len)


def jax_decode(p, cfg, tok, st, pos):
    from repro.models import transformer as jt

    return jt.decode_step(p, cfg, {"token": tok}, st, pos)


# -- the elastic coordinator: tests/test_elastic.py's cases ------------------

def test_healthy_no_plan(tmp_path):
    t = [0.0]
    c = ElasticCoordinator(str(tmp_path), chips_per_worker=4,
                           model_parallel=16, heartbeat_timeout_s=10,
                           clock=lambda: t[0])
    for w in range(128):
        c.beat(w)
    assert c.check() is None


def test_recovery_plan_after_worker_loss(tmp_path):
    ckpt_io.save(str(tmp_path), 42, {"w": torch.zeros(4)})
    t = [0.0]
    c = ElasticCoordinator(str(tmp_path), chips_per_worker=4,
                           model_parallel=16, heartbeat_timeout_s=10,
                           clock=lambda: t[0])
    for w in range(128):       # 128 workers x 4 chips = 512
        c.beat(w)
    t[0] = 8.0
    for w in range(120):       # 8 workers never beat again
        c.beat(w)
    t[0] = 12.0                # workers 120-127 exceeded the 10 s timeout
    plan = c.check()
    assert plan is not None
    assert plan.resume_step == 42
    assert plan.lost_workers == list(range(120, 128))
    # 120 * 4 = 480 chips -> data 16 (the power-of-2 floor of 30), model 16
    assert (plan.data_parallel, plan.model_parallel) == (16, 16)
    launched = []
    c.recover(plan, launched.append)
    assert launched[0] is plan
    assert c.policy.restarts == 0  # reset after a successful recovery


def test_restart_budget_exhausts(tmp_path):
    t = [100.0]
    c = ElasticCoordinator(str(tmp_path), 4, 16, heartbeat_timeout_s=1,
                           policy=RestartPolicy(max_restarts=2),
                           clock=lambda: t[0])
    for w in range(64):
        c.beat(w)
    t[0] = 200.0  # everyone times out except a quorum kept alive
    for w in range(32):
        c.beat(w)
    assert c.check() is not None
    assert c.check() is not None
    with pytest.raises(RuntimeError):
        c.check()


def test_elastic_resumes_from_a_jax_checkpoint(tmp_path):
    """The JAX package's checkpoint layout: the coordinator reads its step."""
    from repro.checkpoint import io as jax_io

    jax_io.save(str(tmp_path), 7, {"w": jnp.zeros(4)})
    t = [0.0]
    c = ElasticCoordinator(str(tmp_path), 4, 4, heartbeat_timeout_s=1,
                           clock=lambda: t[0])
    c.beat(0), c.beat(1)
    t[0] = 0.5
    c.beat(0)
    t[0] = 1.2
    assert c.check().resume_step == 7


# -- the abstract production meshes ------------------------------------------

def test_production_meshes_match_the_jax_package():
    single, multi = (make_production_mesh(multi_pod=m) for m in (False, True))
    assert single.shape == {"data": 16, "model": 16}
    assert single.axis_names == ("data", "model") and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.axis_names == ("pod", "data", "model") and multi.size == 512
    assert (single.tag, multi.tag) == ("16x16", "2x16x16")
    with pytest.raises(ValueError):
        Mesh((2, 2), ("data",))
