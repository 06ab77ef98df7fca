"""Saved state, the LZ4 container and the keyframe thumbnails of the port
(``utils/serialize.py``, ``native.py``, ``core/keyframe.py``) against the
JAX package's, on the CPU.

* a state written by either package's ``save_state`` loads in the other
  with every array equal (``tests/test_aux.py``'s small map, made from a
  numpy seed, with float and with binary descriptors);
* the port's ``compress`` writes the reference's bytes (its native LZ4
  library builds on this machine), each side decompresses the other's
  output, and a ``Z``-tagged (zlib) blob decodes;
* ``make_thumb`` gives the reference's bytes, ``decode_thumb`` inverts it;
* ``FilePrefetcher`` starts and stops, and the ``Prefetcher`` runs it.
"""
import json
import os
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleslam_tpu import native as jnative
from simpleslam_tpu.config import SLAMConfig as JConfig
from simpleslam_tpu.core.keyframe import Keyframe as JKeyframe
from simpleslam_tpu.core.keyframe import make_thumb as jmake_thumb
from simpleslam_tpu.core.map import Map as JMap
from simpleslam_tpu.core.types import Features as JFeatures
from simpleslam_tpu.utils.serialize import load_state as jload_state
from simpleslam_tpu.utils.serialize import save_state as jsave_state
from simpleslam_tpu_torch import native
from simpleslam_tpu_torch.config import SLAMConfig
from simpleslam_tpu_torch.core.keyframe import (Keyframe, decode_thumb,
                                                make_thumb)
from simpleslam_tpu_torch.core.map import Map
from simpleslam_tpu_torch.core.types import Features
from simpleslam_tpu_torch.utils.serialize import load_state, save_state

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

cv2 = pytest.importorskip("cv2")


def _state(MapCls, KfCls, make_feats, binary: bool, thumb: bytes):
    """``tests/test_aux.py::_make_state`` for either package: three poses,
    20 landmarks (one made by keyframe 1), two keyframes, observations on
    the first ten; 8-d float or 32-byte binary descriptors."""
    rng = np.random.default_rng(0)
    m = MapCls()
    m.add_pose(np.eye(4), True)
    T1 = np.eye(4)
    T1[0, 3] = -1.0
    m.add_pose(T1, False)
    m.add_pose(T1, True)
    ids = m.add_points(rng.normal(size=(20, 3)) + [0, 0, 6],
                       rng.uniform(0, 1, (20, 3)).astype(np.float32),
                       keyframe_idx=0)
    m._created_kf[m._row[ids[3]]] = 1
    valid = np.arange(64) < 32
    kpts = np.where(valid[:, None], rng.uniform(0, 100, (64, 2)), 0)
    if binary:
        desc = rng.integers(0, 256, (64, 32), dtype=np.uint8) * valid[:, None]
        obs = [rng.integers(0, 256, 32, dtype=np.uint8) for _ in range(2)]
    else:
        desc = rng.normal(size=(64, 8)).astype(np.float32) * valid[:, None]
        obs = [np.arange(8, dtype=np.float32), rng.normal(size=8)]
    feats = make_feats(kpts.astype(np.float32), desc,
                       valid.astype(np.float32), valid)
    kfs = [KfCls(0, 0, "a.png", feats, np.eye(4), thumb),
           KfCls(1, 2, "", feats, T1, b"")]
    for j, pid in enumerate(ids[:10]):
        m.points[pid].add_observation(0, j, obs[0])
        m.points[pid].add_observation(1, j + 1, obs[1])
    return m, kfs


def _port_feats(*arrays):
    return Features(*map(torch.as_tensor, arrays))


def _ref_feats(*arrays):
    return JFeatures(*map(jnp.asarray, arrays))


def _arrays(path):
    z = np.load(path, allow_pickle=False)
    return {k: z[k] for k in z.files}


@pytest.mark.parametrize("binary", [False, True], ids=["float", "binary"])
def test_reference_state_loads_in_port(tmp_path, binary):
    """The JAX package's file, loaded by the port: every array equal, the
    id remap kept, the features as tensors; saved again, the reference's
    file saved again."""
    thumb = jnative.compress(b"thumbnail bytes " * 8)
    m, kfs = _state(JMap, JKeyframe, _ref_feats, binary, thumb)
    path = str(tmp_path / "ref.npz")
    jsave_state(path, m, kfs, cfg=JConfig(max_features=512),
                frame_ids=[0, 1, 2])
    m2, kfs2, cfg2, fids = load_state(path)
    assert fids == [0, 1, 2] and cfg2["max_features"] == 512
    np.testing.assert_array_equal(m2.get_point_array(), m.get_point_array())
    np.testing.assert_array_equal(m2.get_color_array(), m.get_color_array())
    assert len(m2.poses) == 3 and m2.keyframe_indices == [0, 2]
    for p in range(3):
        np.testing.assert_array_equal(m2.poses[p], m.poses[p])
    assert [m2.points[p].keyframe_idx for p in m2.point_ids()] == \
        [m.points[p].keyframe_idx for p in m.point_ids()]
    # observations as the reference's own load gives them (both re-apply
    # the map's descriptor canonicalisation)
    mj = jload_state(path)[0]
    assert m2.point_ids() == mj.point_ids()
    for p in m2.point_ids():
        a, b = m2.points[p].observations, mj.points[p].observations
        assert [o[:2] for o in a] == [o[:2] for o in b]
        for (_f, _k, da), (_g, _l, db) in zip(a, b):
            np.testing.assert_array_equal(da, db)
    assert len(kfs2) == 2 and kfs2[0].thumb == thumb
    assert (kfs2[0].path, kfs2[1].frame_idx) == ("a.png", 2)
    for k2, k in zip(kfs2, kfs):
        assert k2.idx == k.idx
        np.testing.assert_array_equal(k2.pose, k.pose)
        for name in ("kpts", "desc", "scores", "valid"):
            got = getattr(k2.feats, name)
            assert torch.is_tensor(got)
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(getattr(k.feats, name)))
    # saved again, the same file as the reference's load-and-save (a load
    # re-canonicalises the observations' descriptors in both packages)
    again, ref_again = str(tmp_path / "again.npz"), str(tmp_path / "r.npz")
    save_state(again, m2, kfs2, frame_ids=fids)
    jsave_state(ref_again, *jload_state(path)[:2], frame_ids=fids)
    a, b = _arrays(again), _arrays(ref_again)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("binary", [False, True], ids=["float", "binary"])
def test_port_state_loads_in_reference(tmp_path, binary):
    """The port's file has the reference's keys and dtypes and loads in
    the JAX ``load_state`` equal."""
    thumb = native.compress(b"thumbnail bytes " * 8)
    m, kfs = _state(Map, Keyframe, _port_feats, binary, thumb)
    path = str(tmp_path / "port.npz")
    save_state(path, m, kfs, cfg=SLAMConfig(max_features=512),
               frame_ids=[0, 1, 2])
    ref = str(tmp_path / "ref.npz")
    mj, kfj = _state(JMap, JKeyframe, _ref_feats, binary, thumb)
    jsave_state(ref, mj, kfj, cfg=JConfig(max_features=512),
                frame_ids=[0, 1, 2])
    a, b = _arrays(path), _arrays(ref)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        if k != "config_json":
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    port_cfg = json.loads(bytes(a["config_json"]).decode())
    ref_cfg = json.loads(bytes(b["config_json"]).decode())
    assert port_cfg == {k: ref_cfg[k] for k in port_cfg}

    m2, kfs2, cfg2, fids = jload_state(path)
    assert fids == [0, 1, 2] and cfg2["max_features"] == 512
    np.testing.assert_array_equal(m2.get_point_array(), m.get_point_array())
    np.testing.assert_array_equal(m2.get_color_array(), m.get_color_array())
    assert m2.keyframe_indices == m.keyframe_indices
    assert kfs2[0].thumb == thumb and kfs2[0].path == "a.png"
    for k2, k in zip(kfs2, kfs):
        for name in ("kpts", "desc", "scores", "valid"):
            np.testing.assert_array_equal(np.asarray(getattr(k2.feats, name)),
                                          getattr(k.feats, name).numpy())


def _jpeg(rng):
    img = rng.integers(0, 255, (90, 160, 3), dtype=np.uint8)
    return cv2.imencode(".jpg", img, [int(cv2.IMWRITE_JPEG_QUALITY), 70]
                        )[1].tobytes()


@pytest.mark.parametrize("kind", ["random", "zeros", "jpeg", "text", "empty"])
def test_lz4_bytes_match_reference(kind):
    """The port's container is the reference's byte for byte, and each side
    decompresses the other's."""
    assert jnative.lz4_available()
    rng = np.random.default_rng(1)
    data = {"random": rng.integers(0, 256, 100_000, dtype=np.uint8).tobytes(),
            "zeros": bytes(1 << 20), "jpeg": _jpeg(rng),
            "text": b"keyframe thumbnail " * 500, "empty": b""}[kind]
    ours, ref = native.compress(data), jnative.compress(data)
    assert ours == ref
    assert ours[:1] == (b"Z" if kind == "empty" else b"L")
    assert native.decompress(ref) == data
    assert jnative.decompress(ours) == data


def test_zlib_tag_decodes_and_bad_tags_raise():
    """A ``Z`` blob (the reference's fallback without its native library)
    decodes; an unknown tag and a truncated LZ4 stream raise."""
    data = b"frames " * 1000
    blob = b"Z" + len(data).to_bytes(4, "little") + zlib.compress(data, 6)
    assert native.decompress(blob) == data
    with pytest.raises(ValueError, match="tag"):
        native.decompress(b"Q" + blob[1:])
    good = native.compress(data)
    with pytest.raises(ValueError, match="corrupt"):
        native.decompress(good[:-4])


def test_make_thumb_matches_reference():
    """Resize to (64, 36), JPEG q70, LZ4: the reference's bytes, for a BGR
    array and a tensor; ``decode_thumb`` gives the resized frame back."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (90, 160, 3), dtype=np.uint8)
    ours = make_thumb(img, (64, 36))
    assert ours and ours == jmake_thumb(img, (64, 36))
    assert make_thumb(torch.as_tensor(img), (64, 36)) == ours
    back = decode_thumb(ours)
    assert back.shape == (36, 64, 3) and back.dtype == np.uint8
    assert decode_thumb(b"") is None


def test_thumbs_empty_without_cv2(monkeypatch):
    """Without cv2 the thumbnail is ``b""`` and decodes to None, as in the
    reference."""
    import builtins
    real = builtins.__import__

    def no_cv2(name, *a, **k):
        if name == "cv2":
            raise ImportError("no cv2")
        return real(name, *a, **k)
    blob = make_thumb(np.zeros((20, 30, 3), np.uint8), (8, 6))
    monkeypatch.setattr(builtins, "__import__", no_cv2)
    assert make_thumb(np.zeros((20, 30, 3), np.uint8), (8, 6)) == b""
    assert decode_thumb(blob) is None


def test_file_prefetcher_starts_and_stops(tmp_path):
    """The native readahead thread starts over files (skipping entries
    that are not paths), stops and joins; the dataset ``Prefetcher`` runs
    it over a sequence's frame files and stops it on close."""
    from simpleslam_tpu_torch.data.dataloader import Prefetcher
    paths = []
    for i in range(4):
        p = tmp_path / f"{i:06d}.bin"
        p.write_bytes(os.urandom(4096))
        paths.append(str(p))
    fp = native.FilePrefetcher(paths + [None, 3])
    assert fp._handle
    fp.stop()
    assert fp._handle is None
    fp.stop()
    assert native.FilePrefetcher([])._handle is None

    class Seq:
        frames = paths

        def __len__(self):
            return len(self.frames)

        def frame(self, i):
            with open(self.frames[i], "rb") as f:
                return f.read()
    pf = Prefetcher(Seq(), depth=2, start=1)
    assert pf._native is not None and pf._native._handle
    got = [i for i, _ in pf]
    pf.close()
    assert got == [1, 2, 3] and pf._native._handle is None
