"""The port's trained-weights path against the JAX package's: the OCDBT /
zarr reader (``models/checkpoint.py``) against orbax's restore, the zstd
decoder (``csrc/zstd_decode.c``) against the ``zstandard`` package, the
graft rule against ``_graft_matching``, and the models' default restore.

Tolerances: none. Weights must be bit-identical, decoded bytes identical.
"""
import glob
import logging
import os

import numpy as np
import pytest
import torch
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
from simpleslam_tpu.models.pipeline import (_graft_matching,
                                            _load_repo_checkpoint)
from simpleslam_tpu_torch.models import checkpoint
from simpleslam_tpu_torch.models.pipeline import (LearnedExtractor,
                                                  LearnedMatcher,
                                                  from_jax_params,
                                                  seeded_init_)
from simpleslam_tpu_torch.models import lightglue as tlg
from simpleslam_tpu_torch.utils import zstd

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TREE = os.path.join(ROOT, "checkpoints", "learned_frontend")


@pytest.fixture(scope="module")
def orbax_state_dicts():
    ck = _load_repo_checkpoint(on_error="raise")
    return ck, from_jax_params(jax.tree.map(np.asarray, ck["aliked"]),
                               jax.tree.map(np.asarray, ck["lightglue"]))


def test_reader_matches_orbax_leaf_for_leaf(orbax_state_dicts):
    _ck, (ref_a, ref_l) = orbax_state_dicts
    tree = checkpoint.read_tree(TREE)
    got_a, got_l = from_jax_params(tree["aliked"], tree["lightglue"])
    for ref, got in ((ref_a, got_a), (ref_l, got_l)):
        assert set(ref) == set(got)
        for k in ref:
            assert got[k].dtype == ref[k].dtype, k
            assert torch.equal(got[k], ref[k]), k
    n, size = checkpoint.tree_stats(tree)
    assert n == len(ref_a) + len(ref_l) == 289
    assert size == sum(v.numel() * 4 for v in (*ref_a.values(),
                                                 *ref_l.values()))


def test_models_restore_the_trained_tree_by_default(orbax_state_dicts):
    _ck, (ref_a, ref_l) = orbax_state_dicts
    ext = LearnedExtractor(64, device="cpu")
    mat = LearnedMatcher(ext)
    for ref, model in ((ref_a, ext.model), (ref_l, mat.model)):
        for k, v in model.state_dict().items():
            assert torch.equal(v, ref[k]), k
    # an explicit state_dict still wins
    seeded = seeded_init_(tlg.LightGlue(n_layers=9), 5).state_dict()
    mat2 = LearnedMatcher(ext, state_dict=seeded)
    for k, v in mat2.model.state_dict().items():
        assert torch.equal(v, seeded[k]), k


def test_graft_matches_reference_with_one_wrong_shape(orbax_state_dicts):
    """One leaf of the loaded tree gets the wrong shape: both grafts keep
    the live value there and copy every other leaf."""
    ck, _sds = orbax_state_dicts
    from simpleslam_tpu.models import lightglue as jlg
    _m, live = jlg.init_lightglue(jax.random.PRNGKey(1), desc_dim=128,
                                  n_kp=64, n_layers=3)
    loaded = jax.tree.map(np.asarray, ck["lightglue"])
    loaded["params"]["self1"]["ff1"]["kernel"] = \
        loaded["params"]["self1"]["ff1"]["kernel"][:-1]
    ref = _graft_matching(live, loaded)
    ref_sd = from_jax_params({}, jax.tree.map(np.asarray, ref))[1]
    live_sd = from_jax_params({}, jax.tree.map(np.asarray, live))[1]
    loaded_sd = from_jax_params({}, loaded)[1]

    port = tlg.LightGlue(n_layers=3)
    seeded_init_(port, 1)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    n = checkpoint.graft_matching(port, loaded_sd)
    got = port.state_dict()
    assert n == len(got) - 1
    for k in got:
        if k == "self1.ff1.weight":
            assert torch.equal(ref_sd[k], live_sd[k])
            assert torch.equal(got[k], before[k])
        else:
            assert torch.equal(ref_sd[k], loaded_sd[k]), k
            assert torch.equal(got[k], loaded_sd[k]), k


def test_missing_tree_warns_and_seeds(tmp_path, caplog, monkeypatch):
    missing = str(tmp_path / "no_such_tree")
    with caplog.at_level(logging.WARNING, logger="checkpoint"):
        assert checkpoint.load_frontend_tree(missing) is None
    assert missing in caplog.text
    with pytest.raises(FileNotFoundError):
        checkpoint.load_frontend_tree(missing, on_error="raise")
    monkeypatch.setenv(checkpoint.ENV_VAR, missing)
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="checkpoint"):
        a = LearnedExtractor(64, seed=3, device="cpu")
    assert missing in caplog.text
    want = seeded_init_(type(a.model)(), 3).state_dict()
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_unreadable_tree_raises_on_request(tmp_path):
    bad = tmp_path / "bad_tree"
    bad.mkdir()
    (bad / "_METADATA").write_text('{"tree_metadata": {}}')
    (bad / "manifest.ocdbt").write_bytes(b"\x0c\xdb\x3a\x2a" + b"\0" * 20)
    with pytest.raises(ValueError):
        checkpoint.load_frontend_tree(str(bad), on_error="raise")
    assert checkpoint.load_frontend_tree(str(bad)) is None


def _tree_frames():
    """Every zstd frame of the tree: zarr chunks and B-tree node bodies."""
    store = checkpoint.OcdbtStore(TREE).items()
    frames = [v for k, v in store.items() if not k.endswith(".zarray")]
    for f in glob.glob(os.path.join(TREE, "**", "d", "*"), recursive=True):
        with open(f, "rb") as fh:
            raw = fh.read()
        if raw[:4] == b"\x0c\xdb\x20\xde":
            frames.append(raw[14:-4])
    return frames


def test_decoder_matches_zstandard_on_the_tree():
    frames = _tree_frames()
    assert len(frames) > 150
    ref = zstandard.ZstdDecompressor()
    for raw in frames:
        assert zstd.decompress(raw) == ref.decompress(
            raw, max_output_size=1 << 30)


_WORDS = st.lists(st.binary(min_size=1, max_size=12), min_size=1,
                  max_size=40)


@settings(max_examples=60, deadline=None)
@given(words=_WORDS, picks=st.lists(st.integers(0, 39), max_size=3000),
       noise=st.binary(max_size=2000), level=st.sampled_from([1, 3, 19]),
       checksum=st.booleans(), stream=st.booleans())
def test_decoder_matches_zstandard_on_drawn_bytes(words, picks, noise, level,
                                                  checksum, stream):
    """Compressible text from a drawn vocabulary with drawn noise, at
    levels 1, 3 and 19, with and without a checksum and a declared size."""
    data = b"".join(words[i % len(words)] for i in picks) + noise
    comp = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                    write_content_size=not stream)
    raw = comp.compress(data)
    assert zstd.decompress(raw) == data
    assert zstd.decompress(raw + raw) == data + data


@pytest.mark.parametrize("level", [1, 3, 19])
def test_decoder_matches_zstandard_on_large_inputs(level):
    """Multi-block inputs: float32 noise (Huffman literals, four streams),
    long repeats (large offsets, repeat-offset codes) and a long run."""
    rng = np.random.default_rng(level)
    floats = rng.normal(size=150_000).astype(np.float32).tobytes()
    text = b" ".join(rng.choice([b"alpha", b"beta", b"gamma", b"delta"],
                                size=60_000).tolist())
    data = floats[:300_000] + text + floats[:200_000] + b"\0" * 70_000
    raw = zstandard.ZstdCompressor(level=level).compress(data)
    assert zstd.decompress(raw) == data
    assert zstd.decompress(raw, len(data)) == data
    with pytest.raises(ValueError):
        zstd.decompress(raw[:-7])
