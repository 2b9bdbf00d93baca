"""The port's trainer against the JAX package's on the dense families:
the reduced gemma2-9b (local and global layers, attention and logit
softcaps, tied head), gemma3-12b (5 local to 1 global, qk-norm, tied
head), minitron-8b (untied head) and qwen2-vl-72b (M-RoPE, Adafactor),
through ``tests/test_torch_train_families.py``'s helpers.

Three whole train steps of each (loss, global gradient norm, learning
rate, each step from one state on both sides) are held against the JAX
package's jitted ``make_train_step``; gemma2's and gemma3's rows are
longer than their reduced window of 64, so that their local layers
mask.  qwen2-vl-72b also takes a step on the image path (patch
embeddings at 3-D positions), and gemma3's recompute under remat masks
again and changes no bit.  On the CPU the plain route runs;
``chip_smoke.py`` trains these families through the kernels on the card.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from test_torch_train_families import (_batch, _remat_changes_no_bit,
                                       _steps_match_jax)

ARCHS = ["gemma2-9b", "gemma3-12b", "minitron-8b", "qwen2-vl-72b"]
# rows longer than the reduced local window (64, configs/base.py), so
# that the local layers mask; the others take _batch's default
SEQ_LEN = {"gemma2-9b": 80, "gemma3-12b": 80}


def _image_batch(cfg):
    """A vision-stub batch of 4 rows: seeded patch embeddings of a 4 x 6
    image at their 3-D positions (t = 0, h, w), and the token stream's
    targets at the same length, 24."""
    i = np.arange(24)
    pos = np.stack([np.zeros(24, np.int64), i // 6, i % 6], -1)
    return {"embeds": np.random.default_rng(1).standard_normal(
                (4, 24, cfg.d_model)).astype(np.float32),
            "positions": np.ascontiguousarray(np.broadcast_to(pos,
                                                              (4, 24, 3))),
            "targets": _batch(cfg, 0)["targets"]}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax(arch, tmp_path):
    """Three steps of the reduced config's trainer pieces (AdamW, or
    Adafactor for qwen2-vl-72b, the reference's warmup and cosine
    schedule) against the JAX package's jitted step, as
    ``tests/test_torch_train_families.py`` holds the other families."""
    cfg = get_arch(arch).reduced()
    _steps_match_jax(arch, [_batch(cfg, s, SEQ_LEN.get(arch, 24))
                            for s in range(3)], tmp_path)


def test_image_path_train_step_matches_jax(tmp_path):
    """One step of the reduced qwen2-vl-72b's trainer on a vision-stub
    batch (patch embeddings at an image's 3-D positions, so that M-RoPE's
    three streams differ) against the JAX package's: the token table,
    which the batch never reaches, takes a zero gradient on both sides
    and so an Adafactor step of 0."""
    cfg = get_arch("qwen2-vl-72b").reduced()
    first, params, jparams = _steps_match_jax(
        "qwen2-vl-72b", [_image_batch(cfg)], tmp_path)
    assert torch.equal(params["embed"], first)
    np.testing.assert_array_equal(np.asarray(jparams["embed"]), first.numpy())


def test_remat_full_changes_no_bit():
    """The card trains gemma3-12b under ``remat="full"`` on rows longer
    than its window (the reduced config runs without it): the recompute
    masks the local layers again, and the loss and every gradient equal
    the run without checkpointing bit for bit."""
    _remat_changes_no_bit("gemma3-12b", SEQ_LEN["gemma3-12b"])
