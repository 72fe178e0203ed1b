"""The data of the downstream tasks against the JAX package, bit for bit:
``rle2mask``, the CheXpert, SIIM pneumothorax and RSNA pneumonia image
datasets (``data.frac`` sampling included) on CSV + PNG fixtures, the
synthetic image dataset, ``SupervisedCollate``, the split CSVs of both
preprocess functions, and each task data module's loader batches.

Every comparison is exact (``assert_array_equal`` / equal file text).  Each
package reads its own copy of a fixture tree through its own constants
module; SIIM images are 128² here (``PNEUMOTHORAX_IMG_SIZE`` patched in
both packages) to keep the masks small.  Transforms that would draw from
the JAX package's unseeded task collates (random crop, flip) are left out of
the loader comparisons; the center crop of the other splits draws nothing.
"""

import threading

import cv2
import numpy as np
import pandas as pd
import pytest
import torch

from gloria_tpu import constants as jconst
from gloria_tpu.configs import Config as JConfig
from gloria_tpu.data import data_module as jdm
from gloria_tpu.data import image_dataset as jid
from gloria_tpu.data import preprocess as jpre
from gloria_tpu_torch import constants as tconst
from gloria_tpu_torch.configs import Config as TConfig
from gloria_tpu_torch.data import data_module as tdm
from gloria_tpu_torch.data import image_dataset as tid
from gloria_tpu_torch.data import preprocess as tpre

SIIM_SIZE = 128
LOADER_TIMEOUT_S = 30
TASKS = ["Atelectasis", "Cardiomegaly", "Consolidation", "Edema", "Pleural Effusion"]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _png(path, rng, shape):
    path.parent.mkdir(parents=True, exist_ok=True)
    cv2.imwrite(str(path), (rng.rand(*shape) * 255).astype(np.uint8))
    return str(path)


def _rle(rng) -> str:
    """A relative-start RLE of 1-3 runs inside a SIIM_SIZE² mask."""
    runs, pos = [], 0
    for _ in range(rng.randint(1, 4)):
        start, length = rng.randint(1, 2000), rng.randint(5, 300)
        if pos + start + length > SIIM_SIZE * SIIM_SIZE:
            break
        runs += [start, length]
        pos += start + length
    return " " + " ".join(str(x) for x in runs)


def _tree(root):
    """CheXpert, SIIM and RSNA split CSVs with PNG images under ``root``."""
    rng = np.random.RandomState(0)
    chex = root / "CheXpert-v1.0"
    for split, csv in (("train", "train_split.csv"), ("valid", "valid_split.csv"),
                       ("test", "valid.csv")):
        rows = []
        for i in range(10):
            view = "Lateral" if i % 4 == 3 else "Frontal"
            rel = f"CheXpert-v1.0/{split}/patient{i:05d}/study1/view1_{view.lower()}.png"
            _png(root / rel, rng, tuple(rng.randint(40, 90, size=2)))
            row = {"Path": rel, "Frontal/Lateral": view}
            for t in TASKS:  # positive, negative, uncertain or missing
                row[t] = [1.0, 0.0, -1.0, np.nan][rng.randint(4)]
            rows.append(row)
        pd.DataFrame(rows).to_csv(chex / csv, index=False)

    siim = root / "siim"
    for split in ("train", "valid", "test"):
        rows = []
        for i in range(8):
            iid = f"{split}{i:03d}"
            path = _png(siim / "png" / f"{iid}.png", rng, (SIIM_SIZE, SIIM_SIZE))
            if i % 2:  # a positive, sometimes with two masks
                for _ in range(1 + i % 3 // 2):
                    rows.append({"ImageId": iid, " EncodedPixels": _rle(rng), "Label": 1.0,
                                 "Path": path})
            else:
                rows.append({"ImageId": iid, " EncodedPixels": " -1", "Label": 0.0, "Path": path})
        pd.DataFrame(rows).to_csv(siim / f"{split}.csv")

    rsna = root / "rsna"
    for split, csv in (("train", "train.csv"), ("valid", "val.csv"), ("test", "test.csv")):
        rows = [{"patientId": f"p{i}", "Target": int(rng.rand() > 0.6),
                 "Path": _png(rsna / "png" / f"{split}{i}.png", rng, (70, 60))}
                for i in range(10)]
        pd.DataFrame(rows).to_csv(rsna / csv)
    return root


def _patch(monkeypatch, module, root):
    chex, siim, rsna = root / "CheXpert-v1.0", root / "siim", root / "rsna"
    for name, value in (
            ("CHEXPERT_DATA_DIR", chex), ("CHEXPERT_TRAIN_CSV", chex / "train_split.csv"),
            ("CHEXPERT_VALID_CSV", chex / "valid_split.csv"), ("CHEXPERT_TEST_CSV", chex / "valid.csv"),
            ("PNEUMOTHORAX_DATA_DIR", siim), ("PNEUMOTHORAX_TRAIN_CSV", siim / "train.csv"),
            ("PNEUMOTHORAX_VALID_CSV", siim / "valid.csv"), ("PNEUMOTHORAX_TEST_CSV", siim / "test.csv"),
            ("PNEUMOTHORAX_IMG_SIZE", SIIM_SIZE),
            ("PNEUMONIA_DATA_DIR", rsna), ("PNEUMONIA_TRAIN_CSV", rsna / "train.csv"),
            ("PNEUMONIA_VALID_CSV", rsna / "val.csv"), ("PNEUMONIA_TEST_CSV", rsna / "test.csv")):
        monkeypatch.setattr(module, name, value)


@pytest.fixture
def trees(tmp_path, monkeypatch):
    """One fixture tree per package, each package's constants pointing at its own."""
    _patch(monkeypatch, jconst, _tree(tmp_path / "jax"))
    _patch(monkeypatch, tconst, _tree(tmp_path / "port"))


def _cfg(phase="classification", frac=None, imsize=64, crop=48, dataset="synthetic") -> dict:
    cfg = {"phase": phase, "data": {"dataset": dataset, "image": {"imsize": imsize},
                                    "synthetic_size": 6},
           "transforms": {"norm": "half"},
           "model": {"vision": {"num_targets": 5}},
           "train": {"batch_size": 3, "num_workers": 1}}
    if crop:
        cfg["transforms"]["random_crop"] = {"crop_size": crop}
    if frac is not None:
        cfg["data"]["frac"] = frac
    return cfg


def _same_item(got: dict, ref: dict) -> None:
    assert sorted(got) == sorted(ref)
    for k, r in ref.items():
        if isinstance(r, np.ndarray):
            assert got[k].dtype == r.dtype, k
            np.testing.assert_array_equal(got[k], r, err_msg=k)
        else:
            assert str(got[k]).split("/port/")[-1] == str(r).split("/jax/")[-1], k


def _same_dataset(got, ref) -> None:
    assert len(got) == len(ref) > 0
    for i in range(len(ref)):
        _same_item(got[i], ref[i])


# ---- masks, datasets, collate ------------------------------------------------------

def test_rle2mask_matches_jax():
    """Relative-start runs, filled column-major (the reference's transpose)."""
    rng = np.random.RandomState(1)
    for _ in range(5):
        rle = _rle(rng)
        ref = jid.rle2mask(rle, SIIM_SIZE, SIIM_SIZE)
        got = tid.rle2mask(rle, SIIM_SIZE, SIIM_SIZE)
        assert got.dtype == ref.dtype and got.sum() > 0
        np.testing.assert_array_equal(got, ref)
    square = tid.rle2mask(" 2 3", 4, 4)
    np.testing.assert_array_equal(square[:, 0], [0, 0, 1, 1])  # down the first column
    assert square[0, 1] == 1 and square.sum() == 3


@pytest.mark.parametrize("frac", [None, 0.5])
def test_chexpert_image_dataset_matches_jax(trees, frac):
    """Frontal rows only, NaN → 0, uncertain → U-ones / U-zeros per task, and
    ``data.frac`` of the train split sampled before the frontal filter."""
    for split in ("train", "valid", "test"):
        ref = jid.CheXpertImageDataset(JConfig(_cfg(frac=frac)), split)
        got = tid.CheXpertImageDataset(TConfig(_cfg(frac=frac)), split)
        _same_dataset(got, ref)
    labels = np.stack([got[i]["labels"] for i in range(len(got))])
    assert set(np.unique(labels)) <= {0.0, 1.0}
    assert len(tid.CheXpertImageDataset(TConfig(_cfg(frac=0.5)), "train")) < \
        len(tid.CheXpertImageDataset(TConfig(_cfg()), "train"))


@pytest.mark.parametrize("phase,frac", [("segmentation", None), ("segmentation", 0.5),
                                        ("classification", None)])
def test_pneumothorax_dataset_matches_jax(trees, phase, frac):
    """Masks from the RLEs (several per image summed), the balanced train
    split, ``frac`` and the joint scale-and-rotate augmentation, all drawn
    from the dataset's RandomState(42) in the same order."""
    for split in ("train", "valid", "test"):
        ref = jid.PneumothoraxImageDataset(JConfig(_cfg(phase, frac)), split)
        got = tid.PneumothoraxImageDataset(TConfig(_cfg(phase, frac)), split)
        assert got.imgids == ref.imgids
        _same_dataset(got, ref)
        if phase == "segmentation":
            assert got[0]["labels"].shape == (64, 64)
            assert 0 < sum(got[i]["labels"].sum() > 0 for i in range(len(got))) < len(got)


@pytest.mark.parametrize("frac", [None, 0.5])
def test_pneumonia_dataset_matches_jax(trees, frac):
    for split in ("train", "valid", "test"):
        _same_dataset(tid.PneumoniaImageDataset(TConfig(_cfg(frac=frac)), split),
                      jid.PneumoniaImageDataset(JConfig(_cfg(frac=frac)), split))


def test_read_dicom_needs_pydicom_only_for_dicom(tmp_path):
    path = _png(tmp_path / "a.png", np.random.RandomState(2), (10, 12))
    np.testing.assert_array_equal(tid.read_dicom(path), jid.read_dicom(path))
    try:
        import pydicom  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            tid.read_dicom(str(tmp_path / "a.dcm"))


@pytest.mark.parametrize("segmentation", [False, True])
def test_synthetic_image_dataset_matches_jax(segmentation):
    for seed in (0, 2):
        _same_dataset(tid.SyntheticImageDataset(size=6, imsize=40, num_classes=3,
                                                segmentation=segmentation, seed=seed),
                      jid.SyntheticImageDataset(size=6, imsize=40, num_classes=3,
                                                segmentation=segmentation, seed=seed))


@pytest.mark.parametrize("phase,split", [("classification", "train"),
                                         ("classification", "valid"),
                                         ("segmentation", "train")])
def test_supervised_collate_matches_jax(trees, phase, split):
    """Letterbox + the split's transform (classification; the train case
    without random crop, so it draws nothing) or only the [-1, 1] scaling
    (segmentation images, already at size)."""
    crop = 48 if split != "train" else None
    seg = phase == "segmentation"
    if seg:
        ds = tid.PneumothoraxImageDataset(TConfig(_cfg(phase)), "valid")
    else:
        ds = tid.CheXpertImageDataset(TConfig(_cfg()), "valid")
    instances = [ds[i] for i in range(4)]
    ref = jid.SupervisedCollate(JConfig(_cfg(phase, crop=crop)), split, segmentation=seg)(instances)
    got = tid.SupervisedCollate(TConfig(_cfg(phase, crop=crop)), split, segmentation=seg,
                                seed=0)(instances)
    assert sorted(got) == sorted(ref) == ["_ids", "imgs", "labels"]
    for k in ("imgs", "labels"):
        assert got[k].dtype == ref[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["_ids"] == ref["_ids"]
    assert got["imgs"].shape[1:] == ((64, 64, 3) if seg else (48, 48, 3) if crop else (64, 64, 3))


# ---- preprocessing ------------------------------------------------------------------------

def _original_csvs(root):
    rng = np.random.RandomState(3)
    rows = []
    for i in range(40):
        if i % 3 == 0:
            for _ in range(rng.randint(1, 3)):
                x, y = rng.randint(0, 500, 2)
                rows.append({"patientId": f"p{i:03d}", "x": x, "y": y, "width": 40,
                             "height": 60, "Target": 1})
        else:
            rows.append({"patientId": f"p{i:03d}", "x": np.nan, "y": np.nan, "width": np.nan,
                         "height": np.nan, "Target": 0})
    (root / "rsna").mkdir(parents=True)
    pd.DataFrame(rows).to_csv(root / "rsna" / "stage_2_train_labels.csv", index=False)
    img_dir = root / "siim" / "dicom-images-train"
    rows = []
    for i in range(31):
        sub = img_dir / f"study{i % 4}" / "series"
        sub.mkdir(parents=True, exist_ok=True)
        (sub / f"im{i:03d}.dcm").write_bytes(b"")
        rows.append({"ImageId": f"im{i:03d}", " EncodedPixels": " -1" if i % 2 else "12 4 20 6"})
    pd.DataFrame(rows).to_csv(root / "siim" / "train-rle.csv", index=False)


@pytest.mark.parametrize("dataset", ["pneumonia", "pneumothorax"])
def test_preprocess_writes_the_csvs_jax_writes(tmp_path, monkeypatch, capsys, dataset):
    """Both packages' split CSVs from the same original files are the same
    text (the port computes sklearn's ``train_test_split(random_state=0)``
    itself)."""
    _original_csvs(tmp_path)
    rsna, siim = tmp_path / "rsna", tmp_path / "siim"
    outputs = {}
    for name, const, pre in (("jax", jconst, jpre), ("port", tconst, tpre)):
        for attr, value in (
                ("PNEUMONIA_DATA_DIR", rsna),
                ("PNEUMONIA_ORIGINAL_TRAIN_CSV", rsna / "stage_2_train_labels.csv"),
                ("PNEUMONIA_TRAIN_CSV", rsna / "train.csv"), ("PNEUMONIA_VALID_CSV", rsna / "val.csv"),
                ("PNEUMONIA_TEST_CSV", rsna / "test.csv"),
                ("PNEUMONIA_IMG_DIR", rsna / "stage_2_train_images"),
                ("PNEUMOTHORAX_DATA_DIR", siim),
                ("PNEUMOTHORAX_ORIGINAL_TRAIN_CSV", siim / "train-rle.csv"),
                ("PNEUMOTHORAX_TRAIN_CSV", siim / "train.csv"),
                ("PNEUMOTHORAX_VALID_CSV", siim / "valid.csv"),
                ("PNEUMOTHORAX_TEST_CSV", siim / "test.csv"),
                ("PNEUMOTHORAX_IMG_DIR", siim / "dicom-images-train")):
            monkeypatch.setattr(const, attr, value)
        getattr(pre, f"preprocess_{dataset}_data")()
        d = rsna if dataset == "pneumonia" else siim
        names = ("train", "val", "test") if dataset == "pneumonia" else ("train", "valid", "test")
        outputs[name] = ([(d / f"{n}.csv").read_text() for n in names], capsys.readouterr().out)
    assert outputs["port"] == outputs["jax"]
    assert sum(len(t.splitlines()) - 1 for t in outputs["port"][0]) == \
        (40 if dataset == "pneumonia" else 31)


def test_preprocess_names_the_missing_dataset(tmp_path, monkeypatch):
    monkeypatch.setattr(tconst, "PNEUMONIA_ORIGINAL_TRAIN_CSV", tmp_path / "none.csv")
    with pytest.raises(RuntimeError, match="RSNA Pneumonia"):
        tpre.preprocess_pneumonia_data()
    assert tpre.available_datasets() == ["pneumonia", "pneumothorax"]


# ---- data modules ------------------------------------------------------------------------

def _bounded(fn, seconds: float = LOADER_TIMEOUT_S):
    box = {}

    def target():
        try:
            box["value"] = fn()
        except BaseException as exc:  # handed to the test's thread below
            box["error"] = exc

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"did not finish within {seconds} s"
    if "error" in box:
        raise box["error"]
    return box["value"]


MODULES = [("chexpert", "classification"), ("pneumonia", "classification"),
           ("pneumothorax", "segmentation"), ("pneumothorax", "classification"),
           ("synthetic", "classification"), ("synthetic", "segmentation")]


@pytest.mark.parametrize("dataset,phase", MODULES, ids=[f"{d}-{p}" for d, p in MODULES])
def test_task_data_module_batches_match_jax(trees, dataset, phase):
    """Each package's module gives the same train (shuffled, no random crop),
    valid and test batches; the port's land on the CPU as float32 tensors."""
    cfg = _cfg(phase, crop=None, dataset=dataset)
    jm = jdm.build_data_module(JConfig(cfg))
    tm = tdm.build_data_module(TConfig(cfg), device="cpu")
    assert tm.tokenizer is None
    for split in ("train", "valid", "test"):
        ref = _bounded(lambda: list(jm.loader(split, prefetch=1, process_index=0,
                                              process_count=1)))
        got = _bounded(lambda: list(tm.loader(split, prefetch=1)))
        assert len(got) == len(ref) > 0
        for g, r in zip(got, ref):
            assert sorted(g) == sorted(r)
            for k in ("imgs", "labels"):
                assert isinstance(g[k], torch.Tensor) and g[k].dtype == torch.float32
                np.testing.assert_array_equal(g[k].numpy(), np.asarray(r[k]), err_msg=k)
            assert [str(i).split("/port/")[-1] for i in g["_ids"]] == \
                [str(i).split("/jax/")[-1] for i in r["_ids"]]
