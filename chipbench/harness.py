"""One run of one cell: set-up, the measured window, the check, the result.

Everything that belongs to one configuration, traffic mix, cell or
metric is a file found by name:

- ``BENCHMARK.json`` (the checkout's root): the cell's ``config`` and
  ``traffic`` names and the metrics it reports;
- ``chipbench/configs/<config>.json``: sizes, the port's arch and the keys
  it must match, the arithmetic, the weight recipe, the reference's name;
- ``chipbench/traffic/<traffic>.json``: the mix (``generator.py``) and the
  engine's sizing;
- ``chipbench/cells/<cell>.json``: the check's sample and its limits;
- ``chipbench/e2e/<metric>.py`` and ``chipbench/metrics/<metric>.py`` (or
  the file of the name before its first dot): ``read(run)`` -> a number,
  or None when the run holds nothing to read;
- ``chipbench/reference/<reference>.py``: the plain reference.

The program is ``repro_torch`` (``src/``): the benchmark builds its
engine through ``Session(cfg, params=...).serving_engine(...)`` and drives
``Engine.submit`` / ``Engine.step``.  Each lane's runner is wrapped from
here to log its calls (host clock, rows, positions); nothing of the
program is changed.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import pathlib
import sys
import time

import numpy as np

from . import generator, guard

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = pathlib.Path(__file__).resolve().parent

#: seconds at the end of the window that the traced run profiles; the
#: host-clock readers of a traced run read the window before them
TRACE_SECONDS = 6.0
#: warm-up requests a tier: the mix's longest prompt and its shortest
WARM_NEW = 2

__all__ = ["Cell", "Run", "Setup", "check", "load_reader", "metrics_for",
           "open_setup", "run_window"]


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_reader(kind: str, name: str):
    """``read`` of ``chipbench/<kind>/<name>.py``, else of the file named
    by ``name``'s part before its first dot."""
    base = HERE / kind
    for stem in (name, name.split(".", 1)[0]):
        path = base / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"chipbench_{kind}_{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader {kind}/{name}.py")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    checks: dict
    bench: dict

    @classmethod
    def load(cls, name: str, root: pathlib.Path = ROOT) -> "Cell":
        bench = _json(root / "BENCHMARK.json")
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"known: {sorted(by_name)}")
        w = by_name[name]
        return cls.of(name, w["config"], w["traffic"], bench,
                      chips=int(w["chips"]),
                      checks=_json(HERE / "cells" / f"{name}.json"))

    @classmethod
    def of(cls, name: str, config: str, traffic: str, bench: dict,
           chips: int = 1, checks: dict = None) -> "Cell":
        """A cell from the names of its configuration and traffic files,
        also of a mix that ``BENCHMARK.json`` holds no cell for."""
        return cls(name=name, chips=chips,
                   config=_json(HERE / "configs" / f"{config}.json"),
                   traffic=_json(HERE / "traffic" / f"{traffic}.json"),
                   checks=checks or {}, bench=bench)


def metrics_for(cell: Cell, kind: str) -> list:
    """The cell's metrics of ``kind`` (``end_to_end`` / ``per_layer``): a
    metric with a ``workloads`` key where it lists the cell; a per-layer
    metric without one wherever the cell reports what it moves."""
    e2e = [m for m in cell.bench["end_to_end"]
           if "workloads" not in m or cell.name in m["workloads"]]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in cell.bench["per_layer"]
            if (cell.name in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


class Clock:
    """The engine's and the harness's one clock: ``perf_counter``."""

    def now(self) -> float:
        return time.perf_counter()


@dataclasses.dataclass
class Req:
    """The harness's record of one request (absolute clock times)."""
    rid: str
    tier: str
    due: float
    n_prompt: int
    max_new: int
    submit: float = math.nan
    admit: float = math.nan
    tokens: list = dataclasses.field(default_factory=list)  # times
    finish: float = math.nan
    handle: object = None


@dataclasses.dataclass
class Run:
    """What the readers read."""
    cell: Cell
    seconds: float
    t_start: float                 # process start (harness clock)
    t_traffic: float = math.nan    # the first request is due
    t_open: float = math.nan
    t_end: float = math.nan        # t_open + seconds
    t_close: float = math.nan      # the last step in the window ended
    t_traced: float = math.nan     # the profiler started (traced runs)
    reqs: dict = dataclasses.field(default_factory=dict)
    steps: list = dataclasses.field(default_factory=list)
    calls: list = dataclasses.field(default_factory=list)
    k1_launches: dict = dataclasses.field(default_factory=dict)
    trace: dict = None
    peaks: tuple = None
    queue: dict = dataclasses.field(default_factory=dict)

    @property
    def t_host_end(self) -> float:
        """Where the host-clock readers stop: the close, or in a traced run
        the profiler's start (its cost on the host is the trace's)."""
        return self.t_close if math.isnan(self.t_traced) else self.t_traced

    @property
    def window_reqs(self) -> list:
        """Requests due inside the window."""
        return [r for r in self.reqs.values()
                if self.t_open <= r.due < self.t_end]

    @property
    def window_steps(self) -> list:
        return [s for s in self.steps if s["t0"] >= self.t_open
                and s["t1"] <= self.t_close]

    @property
    def host_steps(self) -> dict:
        """Index -> step, of the window's steps before any tracing."""
        return {i: s for i, s in enumerate(self.steps)
                if s["t0"] >= self.t_open and s["t1"] <= self.t_host_end}

    @property
    def traced_calls(self) -> list:
        return [c for c in self.calls if c["traced"]]


def _wrap(runner, tier: str, run_ref: list, state: dict):
    """Log every call of one lane's runner (decode, a prefill chunk, a
    whole prefill): kind, host interval, rows, tokens and attended
    positions (the program's own methods run unchanged in between)."""
    import torch

    decode, prefill = runner.decode, runner.prefill_chunk_step

    def logged(kind, fn, info):
        def call(*a):
            name = f"chipbench.{kind}.{tier}"
            rec = dict(kind=kind, tier=tier, traced=state["tracing"],
                       step=state["step"], **info(*a))
            t0 = time.perf_counter()
            with torch.profiler.record_function(name):
                out = fn(*a)
            rec.update(t0=t0, t1=time.perf_counter())
            if run_ref[0] is not None:      # None in the warm-up
                run_ref[0].calls.append(rec)
            return out
        return call

    def dec_info(tokens, pos, tables):
        live = np.asarray(tables)[:, 0] != runner.n_pages
        p = np.asarray(pos)[live]
        return dict(rows=int(runner.n_slots), tokens=int(live.sum()),
                    ctx=int((p + 1).sum()))

    def pre_info(prompt, start, end, table_row):
        n = int(end) - int(start)
        return dict(rows=n, tokens=n,
                    ctx=int(sum(range(int(start) + 1, int(end) + 1))))

    def full_info(slot, prompt, table_row):
        n = len(prompt)
        return dict(rows=n, tokens=n, ctx=n * (n + 1) // 2)

    runner.decode = logged("decode", decode, dec_info)
    runner.prefill_chunk_step = logged("prefill", prefill, pre_info)
    # a lane that is not chunked prefills each prompt whole in one call
    runner.prefill_full = logged("prefill", runner.prefill_full, full_info)


@dataclasses.dataclass
class Setup:
    cell: Cell
    seed: int
    device: object
    arch: object
    params: dict
    engine: object
    reqs: list
    clock: Clock
    run_ref: list
    state: dict


def _port_config(cell: Cell, arch=None):
    """The port's arch config for the cell, held key by key against the
    configuration file (``port.keys``, ``port.flags``)."""
    if arch is None:
        from repro_torch.configs import get_arch

        arch = get_arch(cell.config["port"]["arch"])
    for key, attr in cell.config["port"]["keys"].items():
        got = getattr(arch, attr)
        if got != cell.config[key]:
            raise ValueError(f"the port's {attr} = {got!r} but the "
                             f"configuration states {key} = "
                             f"{cell.config[key]!r}")
    for attr, want in cell.config["port"]["flags"].items():
        if getattr(arch, attr) != want:
            raise ValueError(f"the port's {attr} = {getattr(arch, attr)!r}, "
                             f"the configuration states {want!r}")
    return arch


def _hold_tiers(engine, cell: Cell) -> None:
    """Each lane serves the product the configuration states for its tier
    (``numerics.tiers``: K1's passes, the exact tier as one bf16 pass):
    the served tokens cannot tell three passes from one (``PERF.md``), so
    the deployment is held here, at set-up, as the arch's keys are."""
    want = cell.config["numerics"]["tiers"]
    if tuple(engine.tiers) != tuple(want):
        raise ValueError(f"the engine's tiers {engine.tiers} but the "
                         f"configuration states {tuple(want)}")
    for tier, lane in engine._lanes.items():
        num = lane.runner.cfg.numerics
        mode = getattr(num, "mode", None)
        got = None
        if mode == "segmented":
            got = num.seg_passes
        elif mode == "exact" and (num.compute_dtype, num.accum_dtype) \
                == ("bfloat16", "float32"):
            got = 1
        if got != want[tier]:
            raise ValueError(f"the {tier} lane serves {num!r}; the "
                             f"configuration states {want[tier]} pass(es)")


def open_setup(cell: Cell, seed: int, seconds: float, device="cuda",
               arch=None) -> Setup:
    """Weights from the seed on the device, the engine, the traffic."""
    import torch

    from repro_torch.models import transformer
    from repro_torch.session import Session

    from . import weights

    device = torch.device(device)
    arch = _port_config(cell, arch)
    shapes = {k: v[0] for k, v in transformer.param_shapes(arch).items()}
    params = weights.draw(shapes, cell.config["weights"], seed, device)
    eng_cfg = cell.traffic["engine"]
    clock = Clock()
    sess = Session(arch, params=params, device=device)
    engine = sess.serving_engine(
        slots=eng_cfg["slots"], max_len=eng_cfg["max_len"],
        page_size=eng_cfg["page_size"],
        prefill_chunk=eng_cfg["prefill_chunk"], clock=clock)
    _hold_tiers(engine, cell)
    run_ref, state = [None], {"tracing": False, "step": -1}
    for tier, lane in engine._lanes.items():
        _wrap(lane.runner, tier, run_ref, state)
    reqs = generator.generate(cell.traffic, seed, seconds,
                              cell.config["vocab_size"])
    return Setup(cell, seed, device, arch, params, engine, reqs, clock,
                 run_ref, state)


def warm_up(setup: Setup) -> None:
    """Every path the traffic takes, once a tier: the mix's longest and
    shortest prompt, prefilled and decoded."""
    eng = setup.engine
    lens = generator.length_set(setup.cell.traffic["prompt_tokens"], 64)
    rng = generator.rng_for(setup.seed, "warm")
    vocab = setup.cell.config["vocab_size"]
    for tier in eng.tiers:
        for n in (int(lens.max()), int(lens.min())):
            eng.submit(rng.integers(0, vocab, n), tier=tier,
                       max_new_tokens=WARM_NEW)
    eng.run()


def _synchronize(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_window(setup: Setup, run: Run, trace: bool) -> Run:
    """The traffic's load-in (open loop) or first admissions (backlog),
    then the window: submit what is due, step, log."""
    from repro_torch.kernels.afpm_matmul import afpm_matmul

    from .tracing import Profiler

    eng, clock, cell = setup.engine, setup.clock, setup.cell
    setup.run_ref[0] = run
    arr = cell.traffic["arrival"]
    backlog = arr["kind"] == "backlog"
    _synchronize(setup.device)
    t_traffic = clock.now()
    run.t_traffic = t_traffic
    if not backlog:
        run.t_open = t_traffic + float(arr.get("load_in_s", 0.0))
        run.t_end = run.t_open + run.seconds
    prof = Profiler() if trace else None
    t_tr_on = math.inf
    pending = list(setup.reqs)
    i = 0
    first_wave = set()

    def submit_due(now):
        nonlocal i
        while i < len(pending) and t_traffic + pending[i].due <= now:
            g = pending[i]
            r = Req(g.rid, g.tier, t_traffic + g.due, len(g.prompt),
                    g.max_new, submit=now)
            r.handle = eng.submit(g.prompt, tier=g.tier,
                                  max_new_tokens=g.max_new, request_id=g.rid)
            run.reqs[g.rid] = r
            i += 1

    def one_step():
        stats0 = {k: (s.decode_s + s.prefill_s)
                  for k, s in eng.lane_stats().items()}
        setup.state["step"] = len(run.steps)
        t0 = clock.now()
        events = eng.step()
        t1 = clock.now()
        runner_s = sum(s.decode_s + s.prefill_s - stats0[k]
                       for k, s in eng.lane_stats().items())
        for ev in events:
            r = run.reqs[ev.request_id]
            if ev.kind == "admit":
                r.admit = ev.time
            elif ev.kind == "token":
                r.tokens.append(ev.time)
            elif ev.kind == "finish":
                r.finish = ev.time
        run.steps.append(dict(t0=t0, t1=t1, runner_s=runner_s,
                              traced=setup.state["tracing"]))
        return events

    while True:
        now = clock.now()
        submit_due(now)
        if backlog and math.isnan(run.t_open):
            if not run.reqs:
                continue
            for ev in one_step():
                if ev.kind == "admit":
                    first_wave.add(ev.request_id)
            if all(run.reqs[rid].tokens for rid in first_wave):
                run.t_open = clock.now()
                run.t_end = run.t_open + run.seconds
            continue
        if now >= run.t_end:
            break
        if trace:
            t_tr = max(run.t_open, run.t_end - TRACE_SECONDS - 1.0)
            if not setup.state["tracing"] and run.trace is None \
                    and t_tr <= now:
                run.k1_launches["trace0"] = afpm_matmul.launches
                run.t_traced = now
                prof.start()
                setup.state["tracing"] = True
                t_tr_on = clock.now()
            elif setup.state["tracing"] and now >= t_tr_on + TRACE_SECONDS:
                prof.stop()
                setup.state["tracing"] = False
                run.k1_launches["trace1"] = afpm_matmul.launches
                run.trace = {}
        if now >= run.t_open and "open" not in run.queue:
            run.queue["open"] = eng.scheduler.pending()
        if eng.idle:
            nxt = t_traffic + pending[i].due if i < len(pending) else run.t_end
            wait = min(nxt, run.t_end) - clock.now()
            if wait > 0:
                time.sleep(min(wait, 0.002))
            continue
        one_step()
    run.t_close = run.steps[-1]["t1"] if run.steps else clock.now()
    run.t_close = max(run.t_close, run.t_end)
    if setup.state["tracing"]:
        prof.stop()
        setup.state["tracing"] = False
        run.k1_launches["trace1"] = afpm_matmul.launches
    run.queue["close"] = eng.scheduler.pending()
    if prof is not None:
        run.trace = prof.reduce()
    return run


def sample_for_check(run: Run, seed: int, per_tier_tokens: int) -> list:
    """Finished requests of each tier, drawn from the seed, the one with
    the most served tokens first, until the tier's sample holds
    ``per_tier_tokens`` served tokens."""
    rng = generator.rng_for(seed, "check")
    out = []
    by_tier: dict = {}
    for r in run.reqs.values():
        if r.handle is not None and r.handle.done:
            by_tier.setdefault(r.tier, []).append(r)
    for tier in sorted(by_tier):
        rs = sorted(by_tier[tier], key=lambda r: r.rid)
        longest = max(rs, key=lambda r: (len(r.handle.tokens), r.n_prompt))
        rest = [r for r in rs if r is not longest]
        order = [longest] + [rest[j] for j in rng.permutation(len(rest))]
        n = 0
        for r in order:
            out.append(r)
            n += len(r.handle.tokens)
            if n >= per_tier_tokens:
                break
    return out


def load_reference(cell: Cell):
    path = HERE / "reference" / f"{cell.config['reference']}.py"
    spec = importlib.util.spec_from_file_location(
        f"chipbench_reference_{cell.config['reference']}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.Reference


def gaps(ref, sample: list, tier_prod: dict, ctl_prod=None,
         detail: dict = None) -> dict:
    """For each tier, the widest gap by which a served token's logit lies
    below the reference's best (``ctl_prod``: the control's pick in place
    of the served token, read against the same reference).  ``detail``
    collects every position's gap by tier."""
    import torch

    out: dict = {}
    for r in sample:
        req = r.handle
        served = list(req.tokens)
        lg = ref.logits(req.prompt, served, tier_prod[r.tier])
        best = lg.max(dim=-1).values
        if ctl_prod is None:
            pick = torch.as_tensor(served, device=lg.device)
        else:
            prod, head = ctl_prod[r.tier]
            pick = ref.logits(req.prompt, served, prod,
                              head_prod=head).argmax(dim=-1)
        g = best - lg.gather(1, pick[:, None].long())[:, 0]
        out[r.tier] = max(out.get(r.tier, 0.0), g.max().item())
        if detail is not None:
            detail.setdefault(r.tier, []).extend(g.tolist())
    return out


def tier_products(cell: Cell) -> dict:
    return {t: p for t, p in cell.config["numerics"]["tiers"].items()}


def control_products(cell: Cell) -> dict:
    """Each tier's products one step down, and the head's."""
    num = cell.config["numerics"]
    ctl = num["control"]
    head = ctl[str(num["lm_head_passes"])]
    return {t: (ctl[str(p)], head) for t, p in num["tiers"].items()}


def check(setup: Setup, run: Run, control: bool = False):
    """The number compared: ``gap``, the widest gap by which a sampled
    served token's logit lies below the reference's best, over the three
    tiers (each tier's widest on stderr).  With ``control``, also the
    control's reading on the same sample."""
    import torch

    cell = setup.cell
    sample = sample_for_check(run, setup.seed,
                              int(cell.checks["sample_tokens_per_tier"]))
    # the program's state goes before the reference runs: its pools
    for lane in setup.engine._lanes.values():
        lane.runner.pool = None
    gc.collect()
    if setup.device.type == "cuda":
        torch.cuda.empty_cache()
    ref = load_reference(cell)(setup.params, cell.config)
    tiers = list(cell.config["numerics"]["tiers"])

    def named(got):
        print("chipbench: widest gap by tier " + ", ".join(
            f"{t} {got.get(t, math.inf)!r}" for t in tiers), file=sys.stderr)
        return {"gap": max(got.get(t, math.inf) for t in tiers)}

    got = named(gaps(ref, sample, tier_products(cell)))
    if not control:
        return got
    return got, named(gaps(ref, sample, tier_products(cell),
                           control_products(cell)))


def limits_line(readings: dict, limits: dict) -> dict:
    return {k: {"value": v, "limit": limits[k]} for k, v in readings.items()}


def _gpu_name(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def read_metrics(run: Run, specs: list, kind: str) -> dict:
    out = {}
    for m in specs:
        v = load_reader("e2e" if kind == "end_to_end" else "metrics",
                        m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device,
            t_start: float, arch=None) -> dict:
    """Set-up, warm-up, window, metrics and check of one run -> the result
    (``None`` and a line on stderr if a banned module was loaded)."""
    import torch

    from . import work

    cuda = device.type == "cuda"
    marks = [("start", t_start)]

    def mark(name):
        marks.append((name, time.perf_counter()))

    if cuda:
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats()
        from repro_torch.kernels import _build

        _build.build_all()
        mark("kernels built or loaded")
    setup = open_setup(cell, seed, seconds, device, arch=arch)
    mark("weights, engine, traffic")
    warm_up(setup)
    if trace and cuda:
        # CUPTI's first start takes seconds: pay it here, not in the window
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.ones(1, device=device).add_(1)
            torch.cuda.synchronize(device)
    mark("warm-up")
    run = Run(cell=cell, seconds=float(seconds), t_start=t_start)
    run_window(setup, run, bool(trace))
    marks.insert(len(marks), ("load-in or first admissions", run.t_open))
    for (_, a), (name, b) in zip(marks, marks[1:]):
        print(f"chipbench: set-up {name} {b - a:.3f} s", file=sys.stderr)
    print(f"chipbench: window {run.t_close - run.t_open:.3f} s, "
          f"{len(run.window_steps)} steps, {len(run.reqs)} requests, "
          f"queued {run.queue}", file=sys.stderr)
    _synchronize(device)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    run.peaks = work.peaks_for(_gpu_name(device)) if cuda else None
    kind = "per_layer" if trace else "end_to_end"
    metrics = read_metrics(run, metrics_for(cell, kind), kind)
    found = guard.banned_modules()
    if found:
        print(f"chipbench: loaded after the window: {found}", file=sys.stderr)
        return None
    t_check = time.perf_counter()
    readings = check(setup, run)
    print(f"chipbench: check {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr)
    limits = cell.checks["limits"]
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": _gpu_name(device), "count": cell.chips,
                   "memory_peak_bytes": int(peak),
                   "power_limit": work.power_limit() if cuda else "none"}
    result = {"correct": all(readings[k] <= limits[k] for k in readings),
              "attempted": len(run.reqs), "failed": 0, "metrics": metrics,
              "device": device_info}
    if trace and run.trace is not None:
        device_info["busy_s"] = run.trace["busy_s"]
        device_info["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["compared"] = limits_line(readings, limits)
    return result


def main(args, t_start: float) -> int:
    import torch

    cell = Cell.load(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"chipbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    found = guard.banned_modules()
    if found:
        print(f"chipbench: banned modules loaded: {found}", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = execute(cell, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0), t_start)
    if result is None:
        return 3
    for k, v in result["compared"].items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0
