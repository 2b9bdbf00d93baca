"""Serving entry point: batched greedy decoding over the continuous-batching
engine (:mod:`repro_torch.serving`).

The same weights served under exact / segmented3 / segmented2 /
segmented1 numerics.  ``serve()`` routes every prompt through one
accuracy tier of :class:`repro_torch.serving.Engine` with ``batch`` KV
slots and returns the greedy continuations.

    python -m repro_torch.launch.serve --numerics segmented3 --batch 2
    python -m repro_torch.launch.serve --arch mamba2-130m --batch 2
    python -m repro_torch.launch.serve --arch zamba2-7b --batch 2
    python -m repro_torch.launch.serve --arch gemma2-9b --batch 2
    python -m repro_torch.launch.serve --arch deepseek-v3-671b --batch 2
    python -m repro_torch.launch.serve --policy policy.json

runs on the GPU; ``--device cpu`` runs the plain PyTorch path.  The
archs are the reduced (CPU-sized) configs: the dense decoders
``qwen3-4b``, ``gemma2-9b`` (sliding-window layers, softcaps),
``gemma3-12b`` (sliding-window layers), ``minitron-8b`` and
``qwen2-vl-72b`` (M-RoPE; text requests), the MoE decoders
``llama4-maverick-400b-a17b`` and ``deepseek-v3-671b`` (MLA, its latent
caches paged), ``mamba2-130m`` (SSD blocks) and ``zamba2-7b`` (SSD blocks with one shared
attention block, whose lanes page its KV caches and keep the SSD states
per slot, prefilling whole prompts).  ``whisper-tiny`` is refused with a
one-line error: a request carries no encoder inputs.
``--policy`` serves under a per-layer
:class:`~repro_torch.core.policy.NumericsPolicy` JSON file (either
package's, e.g. one ``Session.auto_configure`` emitted) and prints the
policy's modeled area / power (:meth:`Session.ppa_report`); a malformed
or missing file exits with a one-line error.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from repro_torch.session import Session, SessionError, print_ppa_report


def serve(arch: str = "qwen3-4b", batch: int = 4, prompt_len: int = 32,
          gen_len: int = 16, numerics: str = "exact", seed: int = 0,
          params=None, cfg=None, device=None, policy=None):
    """Serve ``arch`` (or a ready ``cfg`` + ``params``) through the
    continuous-batching engine; returns the ``(batch, gen_len)`` greedy
    continuations.  ``numerics`` is a preset name; ``policy`` (a
    NumericsPolicy or a JSON path) overrides it; ``cfg`` (an
    ``ArchConfig``) serves that config as given, e.g. at full width."""
    from repro_torch.serving import TierSpec

    sess = Session(cfg if cfg is not None else arch,
                   policy=policy if policy is not None else numerics,
                   seed=seed, params=params, device=device)
    if policy is not None:
        numerics = "policy"
        print_ppa_report(sess.ppa_report(), tag="serve")
    eng = sess.serving_engine((TierSpec("serve", policy=sess.numerics),),
                              slots=batch, max_len=prompt_len + gen_len)
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, sess.config.vocab, (batch, prompt_len))
    t0 = time.perf_counter()
    reqs = [eng.submit(p, tier="serve", max_new_tokens=gen_len)
            for p in prompts]
    eng.run()
    dt = time.perf_counter() - t0
    print(f"[serve] {sess.arch_id} numerics={numerics} on {sess.device}: "
          f"{batch}x{gen_len} tokens in {dt:.2f}s "
          f"({batch * gen_len / dt:.1f} tok/s, continuous batching)")
    return np.stack([r.result() for r in reqs])


def main(argv=None) -> int:
    from repro_torch.serving import ServingError

    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", default="qwen3-4b",
                    help="qwen3-4b, gemma2-9b, gemma3-12b, minitron-8b, "
                         "mamba2-130m or zamba2-7b (reduced, CPU-sized "
                         "configs)")
    ap.add_argument("--numerics", default="exact",
                    choices=["exact", "segmented3", "segmented2", "segmented1"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--policy", default=None, metavar="POLICY_JSON",
                    help="serve under a per-layer NumericsPolicy (JSON "
                         "file; overrides --numerics)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch path)")
    args = ap.parse_args(argv)
    try:
        serve(args.arch, batch=args.batch, gen_len=args.gen_len,
              numerics=args.numerics, device=args.device,
              policy=args.policy)
    except (SessionError, ServingError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
