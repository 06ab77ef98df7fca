"""Runs of the tiny cells with the timed path broken underneath: each
comes out not correct under the real cells' limits (the look for a card
skipped, everything else as in a run)."""
import torch

import portbench_tiny as tiny
from simpleslam_tpu_torch.models import aliked as aliked_mod
from simpleslam_tpu_torch.models import lightglue as lg_mod
from simpleslam_tpu_torch.models import train as train_mod
from simpleslam_tpu_torch.ops import attention


def _correct(tmp_path, cell):
    rc, line = tiny.run_cell(tiny.files(tmp_path), cell, seed=2**31 + 5)
    assert rc == 0
    return line["correct"]


def test_unbroken_tiny_cells_are_correct(tmp_path):
    assert _correct(tmp_path, "tiny.pairs")
    assert _correct(tmp_path, "tiny.train")


def test_a_match_altered_where_it_is_produced(tmp_path, monkeypatch):
    real = lg_mod.matches_from_assignment

    def altered(P, min_conf):
        m = real(P, min_conf)
        m.idx1[0] = (m.idx1[0] + 1) % P.shape[1]
        return m

    monkeypatch.setattr(lg_mod, "matches_from_assignment", altered)
    assert not _correct(tmp_path, "tiny.pairs")


def test_the_matches_of_one_pair_left_out(tmp_path, monkeypatch):
    real = lg_mod.matches_from_assignment
    calls = []

    def dropped(P, min_conf):
        m = real(P, min_conf)
        calls.append(1)
        if len(calls) % 2:      # the first pair of each call
            m.valid[:] = False
        return m

    monkeypatch.setattr(lg_mod, "matches_from_assignment", dropped)
    assert not _correct(tmp_path, "tiny.pairs")


def test_a_keypoint_altered_where_it_is_produced(tmp_path, monkeypatch):
    real = aliked_mod.dkd_extract

    def altered(*a, **kw):
        f = real(*a, **kw)
        # four pixels: the tiny model's seeded score map is smooth, so
        # two stay inside the limits here (the trained tree fails at one)
        f.kpts[0] += 4.0
        return f

    monkeypatch.setattr(aliked_mod, "dkd_extract", altered)
    assert not _correct(tmp_path, "tiny.pairs")


def test_half_the_frames_left_out(tmp_path, monkeypatch):
    real = aliked_mod.ALIKED.forward

    def half(self, img):
        n = (img.shape[0] + 1) // 2
        score, desc = real(self, img[:n])
        idx = torch.arange(img.shape[0]) % n
        return score[idx], desc[idx]

    monkeypatch.setattr(aliked_mod.ALIKED, "forward", half)
    assert not _correct(tmp_path, "tiny.pairs")


def test_a_step_that_returns_its_state_unchanged(tmp_path, monkeypatch):
    def make_step(tx, hw):
        def step(state, batch):
            metrics, _grad = train_mod.loss_and_grad(state.models, batch, hw)
            return state, metrics
        return step

    monkeypatch.setattr(train_mod, "make_train_step", make_step)
    assert not _correct(tmp_path, "tiny.train")


def test_half_the_batch_left_out(tmp_path, monkeypatch):
    real = train_mod.loss_fn

    def half(aliked, lightglue, batch, image_hw, *a, **kw):
        n = batch["img0"].shape[0] // 2
        return real(aliked, lightglue, {k: v[:n] for k, v in batch.items()},
                    image_hw, *a, **kw)

    monkeypatch.setattr(train_mod, "loss_fn", half)
    assert not _correct(tmp_path, "tiny.train")


def test_the_keys_gradient_left_out(tmp_path, monkeypatch):
    def no_dk(q, k, v, mask_k):     # the keys' gradient comes back 0
        return attention.plain_masked_attention(q, k.detach() + 0.0 * k,
                                                v, mask_k)

    monkeypatch.setattr(lg_mod, "masked_attention", no_dk)
    assert not _correct(tmp_path, "tiny.train")
