"""The port's pretraining data plane against the JAX package: train
transforms, the collate, the native host ingest, the prefetch loader, the
CheXpert and synthetic datasets and data modules, and the nearest map
resize.

Inputs come from numpy seeds.  Tolerances:
- transforms, collate, datasets, data modules, loader batches and the
  nearest resize: bit for bit (the same numpy / cv2 calls on the same
  draws; the resize is a gather of the same source rows);
- the native library, the port's build against the JAX package's: bit for
  bit (one source, one compiler and flags); against the cv2 path, 0.03 on
  normalized pixels and one grey level on raw ones, the JAX tests' bounds
  (area resampling rounds differently).

Every loader test runs under ``_bounded``, so a hang fails in seconds.  The
loader's builder threads share the collate's ``RandomState``, so which batch
takes which crop depends on thread timing whenever several build at once;
the parity tests therefore build one batch at a time (``prefetch=1``, one
worker) or call the collate in order.
"""

import os
import pickle
import threading
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import cv2
import jax.numpy as jnp

from gloria_tpu import constants as jconst
from gloria_tpu.configs import Config as JConfig
from gloria_tpu.data import collate as jcol
from gloria_tpu.data import data_module as jdm
from gloria_tpu.data import loader as jld
from gloria_tpu.data import native as jnat
from gloria_tpu.data import pretraining_dataset as jpd
from gloria_tpu.data import tokenizer as jtok
from gloria_tpu.data import transforms as jtr
from gloria_tpu.ops.resize import resize_maps_nearest as jax_resize_nearest
from gloria_tpu_torch import constants as tconst
from gloria_tpu_torch.configs import Config as TConfig
from gloria_tpu_torch.data import collate as tcol
from gloria_tpu_torch.data import data_module as tdm
from gloria_tpu_torch.data import loader as tld
from gloria_tpu_torch.data import native as tnat
from gloria_tpu_torch.data import pretraining_dataset as tpd
from gloria_tpu_torch.data import tokenizer as ttok
from gloria_tpu_torch.data import transforms as ttr
from gloria_tpu_torch.ops.resize import resize_maps_nearest

LOADER_TIMEOUT_S = 30.0
NATIVE_NORM_ATOL = 0.03


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _bounded(fn, seconds: float = LOADER_TIMEOUT_S):
    """fn() on a daemon thread; fails the test when it has not returned
    within ``seconds``, and re-raises what it raised."""
    box = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as exc:  # handed to the test's thread below
            box["error"] = exc

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"did not finish within {seconds} s"
    if "error" in box:
        raise box["error"]
    return box["value"]


def _jax_native_lib():
    """The JAX package's library, built by its own ``make -C native`` when
    missing.  Another test process may be writing it at the same moment, so
    a failed load is retried a few times."""
    for _ in range(10):
        if jnat.available():
            return jnat
        jnat._lib = None
        time.sleep(1.0)
    pytest.fail("the JAX package's native ingest library did not build or load")


def _data_cfg(imsize=64, crop=48, word_num=24, **extra) -> dict:
    cfg = {"data": {"image": {"imsize": imsize}, "text": {"word_num": word_num}},
           "transforms": {"norm": "half", "random_crop": {"crop_size": crop}}}
    for path, value in extra.items():
        node = cfg
        *parents, leaf = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return cfg


def _assert_batches_equal(got: dict, ref: dict) -> None:
    assert sorted(got) == sorted(ref)
    for k, r in ref.items():
        g = got[k]
        if k in ("_words", "_ids"):
            assert list(g) == list(r), k
            continue
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        r = np.asarray(r)
        assert g.shape == r.shape, k
        if k in ("caption_ids", "attention_mask", "token_type_ids", "cap_lens"):
            assert np.array_equal(g.astype(np.int64), r.astype(np.int64)), k
        else:
            assert g.dtype == r.dtype and np.array_equal(g, r), k


# ---- transforms ---------------------------------------------------------------

TRANSFORMS = {
    "crop": {"random_crop": {"crop_size": 40}},
    "hflip": {"random_horizontal_flip": 0.5},
    "affine": {"random_affine": {"degrees": 10, "translate": [0.1, 0.05],
                                 "scale": [0.9, 1.1]}},
    "affine-rotate-only": {"random_affine": {"degrees": [-5, 15]}},
    "jitter": {"color_jitter": {"bightness": [0.8, 1.2], "contrast": [0.7, 1.3]}},
    "jitter-contrast-only": {"color_jitter": {"contrast": [0.5, 1.5]}},
    "chained": {"random_crop": {"crop_size": 40}, "random_horizontal_flip": 0.5,
                "random_affine": {"degrees": 10, "translate": [0.1, 0.1], "scale": [0.9, 1.1]},
                "color_jitter": {"bightness": [0.8, 1.2], "contrast": [0.8, 1.2]}},
}


@pytest.mark.parametrize("norm", ["half", "imagenet"])
@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_train_transform_matches_jax_bit_for_bit(name, norm):
    """Six images through one transform (its RandomState shared across
    calls), uint8 and float in [0, 1] (the jitter's data-dependent clip)."""
    cfg = {"transforms": {"norm": norm, **TRANSFORMS[name]}}
    ref_t = jtr.build_transformation(JConfig(cfg), "train", seed=7)
    got_t = ttr.build_transformation(TConfig(cfg), "train", seed=7)
    rng = np.random.RandomState(11)
    for i in range(6):
        img = (rng.rand(52, 52, 3) * 255).astype(np.uint8)
        if i % 3 == 2:
            img = img.astype(np.float32) / 255.0
        np.testing.assert_array_equal(got_t(img), ref_t(img), err_msg=f"image {i}")


@pytest.mark.parametrize("split", ["train", "test"])
def test_transform_uint8_output_matches_jax(split):
    """``normalize_output=False``: rounded back to uint8, for the device
    normalization path."""
    cfg = {"transforms": {"norm": "half", **TRANSFORMS["chained"]}}
    cfg["transforms"].pop("color_jitter")
    ref_t = jtr.build_transformation(JConfig(cfg), split, seed=3, normalize_output=False)
    got_t = ttr.build_transformation(TConfig(cfg), split, seed=3, normalize_output=False)
    rng = np.random.RandomState(12)
    for _ in range(4):
        img = (rng.rand(50, 50) * 255).astype(np.uint8)
        got, ref = got_t(img), ref_t(img)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, ref)


def test_batch_images_matches_jax():
    cfg = {"transforms": {"norm": "half", "random_crop": {"crop_size": 32}}}
    rng = np.random.RandomState(13)
    imgs = [(rng.rand(60, 40) * 255).astype(np.uint8), (rng.rand(36, 36) * 255).astype(np.uint8)]
    ref = jtr.batch_images(imgs, jtr.build_transformation(JConfig(cfg), "train", seed=1), 36)
    got = ttr.batch_images(imgs, ttr.build_transformation(TConfig(cfg), "train", seed=1), 36)
    assert got.dtype == np.float32 and got.shape == (2, 32, 32, 3)
    np.testing.assert_array_equal(got, ref)


# ---- nearest resize ---------------------------------------------------------------

@pytest.mark.parametrize("src,dst", [((19, 19), (224, 224)), ((2, 6), (82, 74)),
                                     ((6, 2), (74, 82))])
def test_resize_maps_nearest_matches_jax(src, dst):
    maps = np.random.RandomState(14).randn(3, *src).astype(np.float32)
    ref = np.asarray(jax_resize_nearest(jnp.asarray(maps), dst))
    got = resize_maps_nearest(torch.from_numpy(maps), dst).numpy()
    np.testing.assert_array_equal(got, ref)


def test_float_nearest_index_would_pick_another_row():
    """Why the port gathers with the integer index: torch's float nearest
    index takes another source row at 6 → 74."""
    maps = np.arange(6, dtype=np.float32)[None, :, None].repeat(2, -1)  # row i holds i
    ref = np.asarray(jax_resize_nearest(jnp.asarray(maps), (74, 2)))
    torch_float = F.interpolate(torch.from_numpy(maps)[:, None], size=(74, 2),
                                mode="nearest")[:, 0].numpy()
    assert not np.array_equal(torch_float, ref)
    assert int((torch_float != ref).any(-1).sum()) == 1
    np.testing.assert_array_equal(resize_maps_nearest(torch.from_numpy(maps), (74, 2)).numpy(),
                                  ref)


# ---- native ingest --------------------------------------------------------------

def _native_inputs():
    rng = np.random.RandomState(15)
    imgs = [(rng.rand(390, 320) * 255).astype(np.uint8) for _ in range(3)]
    imgs += [(rng.rand(50, 80) * 255).astype(np.uint8), (rng.rand(20, 30, 3) * 255).astype(np.uint8)]
    n = len(imgs)
    return imgs, rng.randint(0, 33, n), rng.randint(0, 33, n), rng.randint(0, 2, n)


@pytest.mark.parametrize("entry", ["letterbox_normalize_batch", "letterbox_u8_batch",
                                   "letterbox_crop_normalize_batch", "letterbox_crop_u8_batch"])
def test_native_build_matches_jax_library_bit_for_bit(entry):
    jlib = _jax_native_lib()
    imgs, tops, lefts, flips = _native_inputs()
    args = (256,) if "crop" not in entry else (256, 224, tops, lefts, flips)
    got = getattr(tnat, entry)(imgs, *args)
    ref = getattr(jlib, entry)(imgs, *args)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    assert tnat.load().path.parent == tnat.BUILD_DIR  # the port's own build, not native/


def test_native_matches_the_cv2_path():
    """On downscales (CheXpert's 390 × 320 and a 512 × 400 image to 256).  An
    upscale is not compared: there the library interpolates bilinearly, cv2's
    INTER_AREA otherwise (the two packages' libraries agree bit for bit on it
    all the same, above)."""
    imgs, tops, lefts, flips = _native_inputs()
    imgs = imgs[:3] + [(np.random.RandomState(17).rand(512, 400) * 255).astype(np.uint8)]
    tops, lefts, flips = tops[:4], lefts[:4], flips[:4]
    lb = [ttr.letterbox_resize(im, 256) for im in imgs]
    ref = np.stack([ttr.normalize(ttr.to_rgb(x), "half") for x in lb])
    np.testing.assert_allclose(tnat.letterbox_normalize_batch(imgs, 256), ref,
                               rtol=0, atol=NATIVE_NORM_ATOL)
    assert np.abs(tnat.letterbox_u8_batch(imgs, 256)[..., 0].astype(int)
                  - np.stack(lb).astype(int)).max() <= 1
    crops = []
    for x, t, l, f in zip(lb, tops, lefts, flips):
        c = x[t : t + 224, l : l + 224]
        crops.append(c[:, ::-1] if f else c)
    np.testing.assert_allclose(
        tnat.letterbox_crop_normalize_batch(imgs, 256, 224, tops, lefts, flips),
        np.stack([ttr.normalize(ttr.to_rgb(np.ascontiguousarray(c)), "half") for c in crops]),
        rtol=0, atol=NATIVE_NORM_ATOL)
    got_u8 = tnat.letterbox_crop_u8_batch(imgs, 256, 224, tops, lefts, flips)[..., 0]
    assert np.abs(got_u8.astype(int) - np.stack(crops).astype(int)).max() <= 1


def test_native_ingest_without_a_library_raises(monkeypatch, tmp_path):
    """No quiet fallback: a source that does not compile, or no compiler,
    makes every call and the collate that asks for native ingest raise."""
    bad = tmp_path / "ingest.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnat, "_BUILT", None)
    monkeypatch.setattr(tnat, "SOURCE", bad)
    monkeypatch.setattr(tnat, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed"):
        tnat.letterbox_u8_batch([np.zeros((4, 4), np.uint8)], 4)
    cfg = TConfig(_data_cfg(**{"data.native_ingest": True}))
    tok = ttok.WordPieceTokenizer.from_corpus(["no finding"])
    with pytest.raises(RuntimeError, match="native ingest"):
        tcol.GloriaCollate(cfg, "train", tok, seed=0)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="native ingest"):
        tnat.load()


# ---- datasets ---------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 5])
def test_synthetic_dataset_matches_jax(seed):
    ref = jpd.SyntheticPretrainingDataset(size=12, imsize=64, seed=seed)
    got = tpd.SyntheticPretrainingDataset(size=12, imsize=64, seed=seed)
    assert len(got) == len(ref) and got.corpus() == ref.corpus()
    for i in range(len(ref)):
        r, g = ref[i], got[i]
        assert sorted(g) == sorted(r)
        np.testing.assert_array_equal(g["image"], r["image"])
        assert (g["report"], g["id"], g["index"], g["bboxes"]) == \
               (r["report"], r["id"], r["index"], r["bboxes"])


def _chexpert_tree(root, n_frontal=5):
    """A CheXpert-shaped tree under ``root``: CheXpert-v1.0/{train,valid}.csv
    splits with frontal and lateral rows, grayscale PNGs written by cv2."""
    import pandas as pd

    data_dir = root / "CheXpert-v1.0"
    rng = np.random.RandomState(16)
    reports = ["1. Mild cardiomegaly. 2. No pneumothorax.",
               "Small left pleural effusion. Ok.",
               "", "No acute findings. Stable edema at the right lung base.",
               "1. Lines and tubes in place. 2. Improving consolidation."]
    for split, csv in (("train", "train_split.csv"), ("valid", "valid_split.csv"),
                       ("test", "valid.csv")):
        rows = []
        for i in range(n_frontal + 2):
            view = "Lateral" if i in (1, 4) else "Frontal"
            rel = f"CheXpert-v1.0/{split}/patient{i:05d}/study1/view1_{view.lower()}.png"
            (root / rel).parent.mkdir(parents=True, exist_ok=True)
            h, w = (int(v) for v in rng.randint(40, 90, size=2))
            cv2.imwrite(str(root / rel), (rng.rand(h, w) * 255).astype(np.uint8))
            rows.append({"Path": rel, "Frontal/Lateral": view,
                         "Report Impression": reports[i % len(reports)] or None})
        pd.DataFrame(rows).to_csv(data_dir / csv, index=False)
    return data_dir


def _patch_chexpert(monkeypatch, module, data_dir):
    monkeypatch.setattr(module, "CHEXPERT_DATA_DIR", data_dir)
    monkeypatch.setattr(module, "CHEXPERT_TRAIN_CSV", data_dir / "train_split.csv")
    monkeypatch.setattr(module, "CHEXPERT_VALID_CSV", data_dir / "valid_split.csv")
    monkeypatch.setattr(module, "CHEXPERT_TEST_CSV", data_dir / "valid.csv")


@pytest.mark.parametrize("full_report", [False, True])
def test_chexpert_dataset_matches_jax(monkeypatch, tmp_path, full_report):
    """Each package reads its own copy of the tree (each writes its own
    caption cache); then the port reads the JAX package's cache."""
    jdir = _chexpert_tree(tmp_path / "jax")
    tdir = _chexpert_tree(tmp_path / "port")
    _patch_chexpert(monkeypatch, jconst, jdir)
    _patch_chexpert(monkeypatch, tconst, tdir)
    cfg = {"data": {"text": {"full_report": full_report}}}
    for split in ("train", "valid", "test"):
        ref = jpd.CheXpertPretrainingDataset(JConfig(cfg), split)
        got = tpd.CheXpertPretrainingDataset(TConfig(cfg), split)
        assert len(got) == len(ref) == 5  # the two lateral rows are dropped
        for i in range(len(ref)):
            r, g = ref[i], got[i]
            np.testing.assert_array_equal(g["image"], r["image"])
            assert (g["report"], g["id"], g["index"]) == (r["report"], r["id"], r["index"])
        cache = f"captions_{split}.pkl"
        assert pickle.loads((tdir / cache).read_bytes()) == pickle.loads((jdir / cache).read_bytes())
    jax_cache = pickle.loads((jdir / "captions_train.pkl").read_bytes())
    (tdir / "captions_train.pkl").write_bytes(
        pickle.dumps({p: ["from the jax cache"] for p in jax_cache}))
    assert tpd.CheXpertPretrainingDataset(TConfig(cfg), "train")[0]["report"] == \
        "from the jax cache"


def test_iterate_batches_matches_jax():
    cfg = _data_cfg(**{"transforms.random_horizontal_flip": 0.5})
    ds_j, ds_t = jpd.SyntheticPretrainingDataset(10, 64), tpd.SyntheticPretrainingDataset(10, 64)
    corpus = ds_j.corpus()
    cj = jcol.GloriaCollate(JConfig(cfg), "train", jtok.WordPieceTokenizer.from_corpus(corpus), 2)
    ct = tcol.GloriaCollate(TConfig(cfg), "train", ttok.WordPieceTokenizer.from_corpus(corpus), 2)
    ref = list(jpd.iterate_batches(ds_j, cj, 4, seed=3))
    got = list(tpd.iterate_batches(ds_t, ct, 4, seed=3))
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        _assert_batches_equal(g, r)


# ---- collate ----------------------------------------------------------------------

COLLATES = {
    "host": {},
    "device-normalize": {"data.device_normalize": True},
    "hflip-affine": {"transforms.random_horizontal_flip": 0.5,
                     "transforms.random_affine": {"degrees": 8}},
    "jitter-keeps-host-normalize": {"data.device_normalize": True,
                                    "transforms.color_jitter": {"bightness": [0.9, 1.1]}},
    "native": {"data.native_ingest": True, "transforms.random_horizontal_flip": 0.5},
    "native-u8": {"data.native_ingest": True, "data.device_normalize": True,
                  "transforms.random_horizontal_flip": 0.5},
}


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("name", sorted(COLLATES))
def test_collate_matches_jax_bit_for_bit(name, split):
    """Three batches in order through one collate per package: images,
    text arrays, segmentation_labels and the host keys.  Item images of
    80 and 64 px are letterboxed (cv2) to 64 and cropped to 48."""
    if name.startswith("native"):
        _jax_native_lib()
    cfg = _data_cfg(**COLLATES[name])
    ds = jpd.SyntheticPretrainingDataset(size=12, imsize=80)
    items = [ds[i] for i in range(12)]
    for it in items[::3]:
        it["image"] = it["image"][:64]  # a non-square image
    for it in items[1::4]:
        del it["bboxes"]
    corpus = ds.corpus()
    cj = jcol.GloriaCollate(JConfig(cfg), split, jtok.WordPieceTokenizer.from_corpus(corpus), 4)
    ct = tcol.GloriaCollate(TConfig(cfg), split, ttok.WordPieceTokenizer.from_corpus(corpus), 4)
    assert (ct.native_ingest, ct.device_normalize) == (cj.native_ingest, cj.device_normalize)
    for start in (0, 4, 8):
        chunk = items[start : start + 4]
        ref, got = cj(chunk), ct(chunk)
        assert "segmentation_labels" in got and {"_words", "_order", "_ids", "_indices"} <= set(got)
        _assert_batches_equal(got, ref)
    assert sorted(tcol.device_batch(got)) == sorted(k for k in got if not k.startswith("_"))


def test_bbox_mask_helpers_match_jax():
    for bbox in ([2.4, 3.6, 10.5, 7.0], [-3, -1, 5, 4], [0, 0, 0, 0]):
        np.testing.assert_array_equal(tcol.bbox_to_mask(bbox, (9, 12)),
                                      jcol.bbox_to_mask(bbox, (9, 12)))
        m = jcol.bbox_to_mask(bbox, (9, 12))
        assert tcol.mask_to_bbox(m) == jcol.mask_to_bbox(m)


# ---- loader -------------------------------------------------------------------------

class _Ids:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return i


def _ids_collate(items):
    return {"ids": np.asarray(items)}


def _epochs(loader, n=2):
    return [[b["ids"].tolist() for b in loader] for _ in range(n)]


@pytest.mark.parametrize("shuffle,drop_last,weighted", [
    (True, True, False), (False, False, False), (True, False, False), (True, True, True)])
def test_loader_order_matches_jax(shuffle, drop_last, weighted):
    """Two epochs (the order is seeded by seed + epoch), with and without
    shuffle, a ragged last batch and ``sample_weights``."""
    def make(cls):
        lo = cls(_Ids(22), _ids_collate, 4, shuffle=shuffle, seed=3, drop_last=drop_last,
                 num_workers=3, prefetch=2)
        if weighted:
            lo.sample_weights = np.linspace(0.1, 1.0, 22)
        return lo

    ref = _bounded(lambda: _epochs(make(jld.PrefetchLoader)))
    got = _bounded(lambda: _epochs(make(tld.PrefetchLoader)))
    assert got == ref
    assert len(got[0]) == len(make(tld.PrefetchLoader)) == (5 if drop_last else 6)
    assert got[0] != got[1] or not (shuffle or weighted)
    if not weighted:
        flat = [i for b in got[0] for i in b]
        assert len(set(flat)) == len(flat) == (20 if drop_last else 22)
        assert set(flat) <= set(range(22))


def test_loader_process_slices_match_jax():
    """Two per-process loaders with one seed: their slices, in process order,
    are the global batch row for row (a ragged final batch cut evenly), and
    each equals the JAX package's slice."""
    def loaders(cls, **kw):
        return cls(_Ids(22), _ids_collate, 4, seed=3, num_workers=1, drop_last=False, **kw)

    glob = _bounded(lambda: [b["ids"] for b in loaders(tld.PrefetchLoader)])
    local = [_bounded(lambda p=p: [b["ids"] for b in loaders(
        tld.PrefetchLoader, process_index=p, process_count=2)]) for p in range(2)]
    ref = [_bounded(lambda p=p: [b["ids"] for b in loaders(
        jld.PrefetchLoader, process_index=p, process_count=2)]) for p in range(2)]
    assert len(local[0]) == len(local[1]) == len(glob)
    for g, l0, l1 in zip(glob, *local):
        rows = len(g) // 2
        np.testing.assert_array_equal(np.concatenate([l0, l1]), g[: 2 * rows])
    for got, want in zip(local, ref):
        assert [x.tolist() for x in got] == [x.tolist() for x in want]
    with pytest.raises(ValueError, match="divisible"):
        tld.PrefetchLoader(_Ids(8), _ids_collate, 5, process_index=0, process_count=2)
    with pytest.raises(ValueError, match="out of range"):
        tld.PrefetchLoader(_Ids(8), _ids_collate, 4, process_index=2, process_count=2)


def test_loader_raises_worker_errors():
    class Bad:
        def __len__(self):
            return 8

        def __getitem__(self, i):
            if i == 5:
                raise RuntimeError("boom")
            return i

    loader = tld.PrefetchLoader(Bad(), _ids_collate, 2, shuffle=False, num_workers=2)
    with pytest.raises(RuntimeError, match="boom"):
        _bounded(lambda: list(loader))


def _loader_threads():
    return [t for t in threading.enumerate() if t.name.startswith(tld.THREAD_PREFIX)]


def _wait_for_no_loader_threads(seconds: float = 10.0) -> None:
    deadline = time.monotonic() + seconds
    while _loader_threads() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not _loader_threads(), [t.name for t in _loader_threads()]


def test_loader_early_break_leaves_no_thread():
    """A consumer that takes one batch and stops: the producer, blocked on a
    full queue, and the builder pool end within a few poll periods."""
    _wait_for_no_loader_threads()  # those of an earlier test in this process

    def slow_collate(items):
        time.sleep(0.05)
        return _ids_collate(items)

    loader = tld.PrefetchLoader(_Ids(64), slow_collate, 2, num_workers=4, prefetch=3)

    def take_one():
        for batch in loader:
            return batch["ids"].tolist()

    assert len(_bounded(take_one)) == 2
    _wait_for_no_loader_threads()


def test_loader_to_device_runs_in_the_consumer_thread():
    seen = set()

    def to_device(batch):
        seen.add(threading.get_ident())
        return batch

    def consume():
        return list(loader), threading.get_ident()

    loader = tld.PrefetchLoader(_Ids(12), _ids_collate, 4, num_workers=2, to_device=to_device)
    batches, consumer = _bounded(consume)
    assert len(batches) == 3 and seen == {consumer}


# ---- data modules ---------------------------------------------------------------------

def _module_cfg(dataset="synthetic", **extra) -> dict:
    cfg = _data_cfg(**{"data.dataset": dataset, "data.synthetic_size": 20,
                       "transforms.random_horizontal_flip": 0.5, **extra})
    cfg["train"] = {"batch_size": 4, "num_workers": 1}
    cfg["model"] = {"text": {"bert_type": None}}
    return cfg


def _module_batches(module, split, **kw):
    return _bounded(lambda: list(module.loader(split, prefetch=1, **kw)))


@pytest.mark.parametrize("dataset", ["synthetic", "chexpert"])
def test_data_module_batches_match_jax(monkeypatch, tmp_path, dataset):
    """The train and valid loaders of each package's module (tokenizer built
    from the corpus: no vocab file, no HF cache) give the same batches; the
    port's land on the CPU as tensors, host keys untouched."""
    if dataset == "chexpert":
        _patch_chexpert(monkeypatch, jconst, _chexpert_tree(tmp_path / "jax", n_frontal=9))
        _patch_chexpert(monkeypatch, tconst, _chexpert_tree(tmp_path / "port", n_frontal=9))
    cfg = _module_cfg(dataset)
    jm = jdm.build_data_module(JConfig(cfg))
    tm = tdm.build_data_module(TConfig(cfg), device="cpu")
    assert tm.tokenizer.vocab == jm.tokenizer.vocab
    for split in ("train", "valid"):
        ref = _module_batches(jm, split, process_index=0, process_count=1)
        got = _module_batches(tm, split)
        assert len(got) == len(ref) > 0
        for g, r in zip(got, ref):
            assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
                       for k, v in g.items() if not k.startswith("_"))
            assert isinstance(g["_words"], list) and isinstance(g["_order"], np.ndarray)
            _assert_batches_equal(g, {k: np.asarray(v) if not k.startswith("_") else v
                                      for k, v in r.items()})


def test_data_module_refusals(monkeypatch):
    for name, item in (("pneumonia", "A5"), ("pneumothorax", "A5"), ("imagenome", "A6")):
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
            tdm.build_data_module(TConfig(_module_cfg(name)), device="cpu")
    for phase in ("classification", "segmentation"):
        cfg = TConfig(_module_cfg())
        cfg.phase = phase
        with pytest.raises(NotImplementedError, match="ROADMAP.md A5"):
            tdm.build_data_module(cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdm.build_data_module(TConfig(_module_cfg()))


def test_importing_the_port_builds_nothing(tmp_path):
    """``import gloria_tpu_torch`` and its data modules compile nothing: the
    native library is built at its first use only."""
    import subprocess
    import sys

    code = ("import gloria_tpu_torch.data.native as n, gloria_tpu_torch.data.data_module, "
            "gloria_tpu_torch.data.collate; import sys; sys.exit(0 if n._BUILT is None else 1)")
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "CXX")}
    env["CXX"] = str(tmp_path / "no-such-compiler")  # any build attempt would fail loudly
    proc = subprocess.run([sys.executable, "-c", code], cwd=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
