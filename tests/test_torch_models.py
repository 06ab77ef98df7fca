"""Learned front-end parity: the port's ALIKED and LightGlue against the
JAX package's on the CPU, with the JAX parameters carried over by
``from_jax_params``.

Both sides run the reference's mixed precision (bfloat16 projections and
convolutions, float32 norms and softmaxes), which round at different
places in the two frameworks; tolerances are therefore bf16-level: the
assignment P within 2e-2 absolute (P lies in [0, 1]), keypoints within
0.1 px on the common top-K, descriptors within 2e-2.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from simpleslam_tpu.models import aliked as jaliked
from simpleslam_tpu.models import lightglue as jlg
from simpleslam_tpu_torch.core.types import Features
from simpleslam_tpu_torch.models import aliked as taliked
from simpleslam_tpu_torch.models import lightglue as tlg
from simpleslam_tpu_torch.models.pipeline import (LearnedExtractor,
                                                  LearnedMatcher,
                                                  from_jax_params,
                                                  jax_tree_to_state_dict)

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _random_features(rng, N, n_valid, hw=(120, 160), D=128):
    H, W = hw
    kpts = np.column_stack([rng.uniform(0, W, N), rng.uniform(0, H, N)]
                           ).astype(np.float32)
    desc = rng.normal(size=(N, D)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    valid = np.zeros(N, bool)
    valid[:n_valid] = True
    return kpts, desc, valid


@pytest.fixture(scope="module")
def lightglue_pair():
    model, params = jlg.init_lightglue(jax.random.PRNGKey(3), desc_dim=128,
                                       n_kp=64, dim=256, heads=4, n_layers=3)
    tmodel = tlg.LightGlue(desc_dim=128, n_layers=3)
    tmodel.load_state_dict(jax_tree_to_state_dict(_np_tree(params)),
                           strict=True)
    return model, params, tmodel.eval()


def test_state_dict_names_follow_torch_import_convention(lightglue_pair):
    from simpleslam_tpu.models.torch_import import export_state_dict
    _model, params, tmodel = lightglue_pair
    ref = export_state_dict(params)
    ours = jax_tree_to_state_dict(_np_tree(params))
    assert set(ref) == set(ours) == set(tmodel.state_dict())
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), ref[k])


def test_lightglue_matches_reference(lightglue_pair):
    model, params, tmodel = lightglue_pair
    rng = np.random.default_rng(0)
    N, hw = 128, (120, 160)
    k0, d0, v0 = _random_features(rng, N, 110, hw)
    # the second set is a noisy, shifted, permuted copy of the first
    perm = rng.permutation(N)
    k1 = (k0[perm] + rng.normal(scale=0.5, size=(N, 2)) + [3.0, 1.0]
          ).astype(np.float32)
    d1 = d0[perm] + 0.1 * rng.normal(size=d0.shape).astype(np.float32)
    d1 = (d1 / np.linalg.norm(d1, axis=1, keepdims=True)).astype(np.float32)
    v1 = v0[perm]
    Pj, s0j, s1j = model.apply(params, *(jnp.asarray(a)[None] for a in
                                         (k0, d0, v0, k1, d1, v1)), hw)
    with torch.no_grad():
        Pt, s0t, s1t = tmodel(*(torch.from_numpy(a)[None] for a in
                                (k0, d0, v0, k1, d1, v1)), hw)
    Pj = np.asarray(Pj)[0]
    Pt = Pt[0].numpy()
    np.testing.assert_allclose(Pt, Pj, atol=2e-2)
    np.testing.assert_allclose(s0t.numpy(), np.asarray(s0j), atol=2e-2)

    # the Matches tuple, in order, from one assignment through both
    # matches_from_assignment implementations
    mj = jlg.matches_from_assignment(jnp.asarray(Pj), 0.05)
    mt = tlg.matches_from_assignment(torch.from_numpy(Pj), 0.05)
    assert np.asarray(mj.valid).sum() > 5
    for a, b in ((mt.idx0, mj.idx0), (mt.idx1, mj.idx1),
                 (mt.valid, mj.valid)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(mt.score.numpy(), np.asarray(mj.score))
    # and from each side's own forward: the same confident matches
    mt2 = tlg.matches_from_assignment(torch.from_numpy(Pt), 0.05)
    pairs_j = set(zip(np.asarray(mj.idx0)[np.asarray(mj.valid)],
                      np.asarray(mj.idx1)[np.asarray(mj.valid)]))
    pairs_t = set(zip(mt2.idx0[mt2.valid].numpy(), mt2.idx1[mt2.valid].numpy()))
    assert len(pairs_j ^ pairs_t) <= max(2, len(pairs_j) // 20)


def test_matches_order_is_stable_under_ties():
    P = torch.zeros(6, 6)
    for i in range(6):
        P[i, (i + 1) % 6] = 0.9          # all confidences tie
    m = tlg.matches_from_assignment(P, 0.5)
    assert m.idx0.tolist() == list(range(6))
    mj = jlg.matches_from_assignment(jnp.asarray(P.numpy()), 0.5)
    assert np.asarray(mj.idx0).tolist() == m.idx0.tolist()


def test_apply_rotary_and_space_to_depth_match_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, 4, 16, 64)).astype(np.float32)
    th = rng.normal(size=(1, 1, 16, 32)).astype(np.float32)
    np.testing.assert_allclose(
        tlg.apply_rotary(torch.from_numpy(x), torch.from_numpy(th)).numpy(),
        np.asarray(jlg.apply_rotary(jnp.asarray(x), jnp.asarray(th))),
        atol=1e-5)
    img = rng.normal(size=(2, 8, 12, 3)).astype(np.float32)
    want = np.asarray(jaliked.space_to_depth(jnp.asarray(img), 2))
    got = taliked.space_to_depth(torch.from_numpy(img).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.fixture(scope="module")
def aliked_pair():
    model, params = jaliked.init_aliked(jax.random.PRNGKey(5), desc_dim=128,
                                        image_hw=(64, 96))
    tmodel = taliked.ALIKED(desc_dim=128)
    tmodel.load_state_dict(jax_tree_to_state_dict(_np_tree(params)),
                           strict=True)
    return model, params, tmodel.eval()


def _image(seed, hw=(64, 96)):
    from scipy.ndimage import gaussian_filter
    rng = np.random.default_rng(seed)
    img = gaussian_filter(rng.uniform(0, 255, size=hw), 1.5)
    img = (img - img.min()) / (img.max() - img.min()) * 255
    return img.astype(np.uint8)


def test_aliked_forward_and_keypoints_match_reference(aliked_pair):
    model, params, tmodel = aliked_pair
    img = _image(0)
    x_j = jaliked.preprocess_image(jnp.asarray(img))
    x_t = taliked.preprocess_image(torch.from_numpy(img))
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), atol=1e-6)
    sj, dj = model.apply(params, x_j[None])
    with torch.no_grad():
        st, dt = tmodel(x_t[None])
    # bf16 convolutions: compare relative to the map's spread
    sj, dj = np.asarray(sj), np.asarray(dj)
    assert np.abs(st.numpy() - sj).max() < 2e-2 * (np.ptp(sj) + 1e-6)
    assert np.abs(dt.numpy() - dj).max() < 2e-2 * (np.ptp(dj) + 1e-6)

    K = 128
    fj = jaliked.dkd_extract(jnp.asarray(sj[0]), jnp.asarray(dj[0]), K)
    fj = jax.tree.map(np.asarray, fj)
    with torch.no_grad():
        ft = taliked.dkd_extract(st[0], dt[0], K)
    # same score maps give the same keypoints; on the forward's own maps,
    # the common top-K agrees within 0.1 px
    with torch.no_grad():
        fs = taliked.dkd_extract(torch.from_numpy(sj[0]),
                                 torch.from_numpy(dj[0]), K)
    np.testing.assert_array_equal(fs.valid.numpy(), fj.valid)
    np.testing.assert_allclose(fs.kpts.numpy()[fj.valid],
                               fj.kpts[fj.valid], atol=1e-4)
    np.testing.assert_allclose(fs.desc.numpy(), fj.desc, atol=1e-5)
    kj = fj.kpts[fj.valid]
    kt = ft.kpts.numpy()[ft.valid.numpy()]
    d = np.linalg.norm(kt[:, None] - kj[None], axis=-1)
    close = d.min(1) < 0.1
    assert close.mean() > 0.8, close.mean()
    i_t = np.flatnonzero(close)
    i_j = d.argmin(1)[close]
    dd = np.abs(ft.desc.numpy()[ft.valid.numpy()][i_t]
                - fj.desc[fj.valid][i_j]).max()
    assert dd < 2e-2, dd


def test_learned_pipeline_bundles_on_cpu(aliked_pair, lightglue_pair):
    _m, a_params, _t = aliked_pair
    _m2, l_params, _t2 = lightglue_pair
    a_sd, l_sd = from_jax_params(_np_tree(a_params), _np_tree(l_params))
    ext = LearnedExtractor(128, device="cpu", state_dict=a_sd)
    mat = LearnedMatcher(ext, min_conf=0.05, n_layers=3, state_dict=l_sd)
    img = torch.from_numpy(_image(1)).float()
    f0 = ext.fn(img)
    f1 = ext.fn(torch.roll(img, 2, dims=1))
    assert isinstance(f0, Features) and f0.kpts.shape == (128, 2)
    m = mat.fn(f0, f1)
    assert m.idx0.shape == (128,) and mat.calls == 1
    seeded = LearnedExtractor(128, seed=0, device="cpu")
    seeded2 = LearnedExtractor(128, seed=0, device="cpu")
    for (k, a), (_k, b) in zip(seeded.model.state_dict().items(),
                               seeded2.model.state_dict().items()):
        assert torch.equal(a, b), k


def test_entry_points_raise_without_a_device_and_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LearnedExtractor(128)


def _wrong_attention(which):
    """A deliberately wrong masked attention, as a faulty kernel might be."""
    plain = tlg.masked_attention

    def fn(q, k, v, m):
        if which == "mask_ignored":
            return plain(q, k, v, torch.ones_like(m))
        if which == "live_key_tile_dropped":
            m = m.clone()
            m[:, 128:192] = False
            return plain(q, k, v, m)
        if which == "scale_1_over_d":
            return plain(q / 8.0, k, v, m)
        o = plain(q, k, v, m)             # "query_tile_zeroed"
        o[:, 64:128] = 0.0
        return o
    return fn


@pytest.mark.parametrize("which", ["mask_ignored", "live_key_tile_dropped",
                                   "scale_1_over_d", "query_tile_zeroed"])
def test_descriptor_check_separates_wrong_attention(which, monkeypatch):
    """chip_smoke.py phase 4's check (final descriptors, relative error
    within DESC_TOL) at full width, 9 layers, seeded weights: a wrong
    attention lands well outside the tolerance."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import chip_smoke
    from simpleslam_tpu_torch.models.pipeline import seeded_init_
    N, hw = 256, (376, 1232)
    model = seeded_init_(tlg.LightGlue(n_layers=9), 1).eval()
    rng = np.random.default_rng(0)
    args = []
    for _ in range(2):
        k, d, v = _random_features(rng, N, int(0.85 * N), hw=hw)
        args += [torch.as_tensor(k)[None], torch.as_tensor(d)[None],
                 torch.as_tensor(v)[None]]
    valid = torch.cat([args[2][0], args[5][0]])

    def descriptors():
        outs = []
        hook = model.final_proj.register_forward_hook(
            lambda _m, _i, o: outs.append(o[0].float()))
        with torch.no_grad():
            model(*args[:3], *args[3:], hw)
        hook.remove()
        return torch.cat(outs)

    good = descriptors()
    monkeypatch.setattr(tlg, "masked_attention", _wrong_attention(which))
    err = chip_smoke.desc_rel_err(descriptors(), good, valid)
    assert err > 2 * chip_smoke.DESC_TOL, err
