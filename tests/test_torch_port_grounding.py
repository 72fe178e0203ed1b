"""The port's ImaGenome grounding path against the JAX package: the objects
index, the sentences table, every ``ImaGenomeDataset`` perturbation, the
text maskers, the ``imagenome`` data module, the localization metrics and
callbacks, the train step's attention outputs, and the whole driver on a
tiny ImaGenome config.

The data is a synthetic MIMIC-CXR / Chest ImaGenome mirror written by
:func:`write_mirror` in ``tests/test_mimic.py``'s layout (image cache,
silver scene graphs, reports, split tables, gold table), one copy for each
package, since both write caches into it.  Random draws come from numpy and
``random.Random`` seeds.  Tolerances:
- objects, sentence tables, dataset items, masked texts and loader batches:
  equal (bit for bit for the arrays);
- ``topk_overlap_metrics``: equal; ``attention_entropy_np`` and the
  sentence attention: equal (the same numpy calls); AUROC and AP, through
  ``batch_localization_metrics``: 1e-6 absolute (f32 sums of ranks in
  another order); the ROC and PR curves: equal to sklearn's, dtypes
  included;
- ``EvaluateLocalization`` on the same attention and batch: ``sentences.csv``
  as above, the artifacts equal; ``WeightInstancesByLocalization``'s
  weights 1e-12 absolute (float64 on the same numbers);
- the train step's ``_attn``, ``_local_sims`` and ``_global_sims`` against
  JAX's train step with ``return_attn=True`` from the same weights (tiny
  width, dropout 0): 1e-5, 1e-4 and 1e-4 absolute (the towers' f32 sums in
  another order; the losses of that step agree to 1e-4 relative,
  ``tests/test_torch_port_train.py``);
- the whole driver against JAX's ``run.py`` (SGD, no random crop, so the
  loaders draw nothing; JAX's initial weights): losses ``STEP_RTOL``
  relative; ``sentences.csv``'s similarity columns 1e-3 absolute, AUROC and
  AP 2e-3, the entropy and the no-attention weight 1e-4, the top-k family
  ``TOPK_ATOL`` (a pixel whose overlay moves by f32 noise across the
  threshold moves precision by 1/k).
"""

import ast
import json
import os
import pickle
import random
import shutil
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from gloria_tpu.configs import Config as JConfig
from gloria_tpu.data import data_module as jdm
from gloria_tpu.data import mimic as jm
from gloria_tpu.data import text_masking as jtm
from gloria_tpu.training import localization as jloc
from gloria_tpu.training import metrics as jmet
from gloria_tpu_torch import run
from gloria_tpu_torch.configs import Config as TConfig
from gloria_tpu_torch.data import data_module as tdm
from gloria_tpu_torch.data import mimic as tm
from gloria_tpu_torch.data import text_masking as ttm
from gloria_tpu_torch.training import localization as tloc
from gloria_tpu_torch.training import metrics as tmet
from gloria_tpu_torch.training import optim, train
from gloria_tpu_torch.utils.weights import state_dict_from_jax

ROOT = Path(__file__).resolve().parents[1]
STEP_RTOL = 1e-4  # as tests/test_torch_port_driver.py
TOPK_ATOL = 2e-2

BBOXES = ["left lung", "right lung", "left lower lung zone", "right lower lung zone",
          "left upper lung zone", "right upper lung zone", "cardiac silhouette",
          "mediastinum", "left costophrenic angle", "right costophrenic angle"]
CONDITIONS = ["lung opacity", "pleural effusion", "atelectasis", "pneumothorax",
              "enlarged cardiac silhouette", "abnormal", "normal", "consolidation"]
FILLER = ["mild", "small", "stable", "new", "subtle", "patchy", "likely", "again", "seen"]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ---- the synthetic mirror -------------------------------------------------------

def _sentence(rng, cond, locs) -> str:
    words = [FILLER[i] for i in rng.choice(len(FILLER), rng.randint(1, 4), replace=False)]
    return f"There is {' '.join(words)} {cond} in the {' and '.join(locs)}."


def write_mirror(root: Path, n_dicoms: int = 12, imsize: int = 64, seed: int = 0) -> dict:
    """A MIMIC-CXR / ImaGenome mirror under ``root``: per dicom a uint8
    image in the image cache, a report and a silver scene graph of 3-5
    objects and 2-4 sentences (some on two objects, some with two
    conditions); the split tables (dicoms 0-5 train, 6-8 valid, 9+ test,
    which is also the gold set) and a gold table for the gold dicoms.
    Returns the two mirror directories and the records."""
    rng = np.random.RandomState(seed)
    mimic_dir, imagenome_dir = root / "mimic-cxr", root / "chest-imagenome"
    filer, imagenome = tm.MimicCxrFiler(str(mimic_dir)), tm.ImaGenomeFiler(str(imagenome_dir))
    records, gold_rows = [], []
    for i in range(n_dicoms):
        dicom = f"d{i:04d}"
        rec = {"subject_id": 10000 + i // 2, "study_id": 50000 + i, "dicom_id": dicom,
               "ViewPosition": "PA" if i % 3 else "AP"}
        records.append(rec)
        path = Path(filer.image_cache_path(dicom))
        path.parent.mkdir(parents=True, exist_ok=True)
        np.save(path, rng.randint(0, 256, (imsize, imsize)).astype(np.uint8))
        names = [BBOXES[j] for j in rng.choice(len(BBOXES), rng.randint(3, 6), replace=False)]
        objects = []
        for name in names:
            x1, y1 = (int(v) for v in rng.randint(0, imsize // 2, 2))
            x2, y2 = x1 + int(rng.randint(4, imsize // 2)), y1 + int(rng.randint(4, imsize // 2))
            objects.append({"object_id": f"{dicom}_{name}", "bbox_name": name,
                            "original_x1": x1, "original_y1": y1,
                            "original_x2": x2, "original_y2": y2})
        attributes = {o["object_id"]: {"object_id": o["object_id"], "phrase_IDs": [], "phrases": [],
                                       "attributes": []} for o in objects}
        sentences = []
        for s in range(rng.randint(2, 5)):
            on = [objects[j] for j in rng.choice(len(objects), 1 + (s % 3 == 1), replace=False)]
            conds = [CONDITIONS[j] for j in rng.choice(len(CONDITIONS), 1 + (s == 2), replace=False)]
            text = _sentence(rng, conds[0], [o["bbox_name"] for o in on])
            sentences.append(text)
            for o in on:
                a = attributes[o["object_id"]]
                a["phrase_IDs"].append(f"{dicom}_s{s}")
                a["phrases"].append(text)
                a["attributes"].append([f"anatomicalfinding|{rng.choice(['yes', 'no'])}|{c}"
                                        for c in conds])
                gold_rows.append({"image_id": f"{dicom}.dcm", "bbox": o["bbox_name"],
                                  "coord_original": "({}, {}, {}, {})".format(
                                      o["original_x1"], o["original_y1"],
                                      o["original_x2"], o["original_y2"]),
                                  "row_id": 100 * i + s, "sentence": text,
                                  "label_name": conds[0], "context": "yes"})
        scene = {"objects": objects,
                 "attributes": list(attributes.values())
                 + [{"object_id": f"{dicom}_missing", "phrase_IDs": ["x"], "phrases": ["x"],
                     "attributes": [["a|yes|b"]]}]}
        sg = Path(imagenome.get_silver_scene_graph_json_file(dicom))
        sg.parent.mkdir(parents=True, exist_ok=True)
        sg.write_text(json.dumps(scene))
        report = Path(filer.get_full_path(filer.report_relpath(rec["subject_id"], rec["study_id"])))
        report.parent.mkdir(parents=True, exist_ok=True)
        report.write_text("FINDINGS: " + " ".join(sentences) + "\nIMPRESSION: " + sentences[0])
    df = pd.DataFrame(records)
    splits = Path(imagenome.get_full_path("silver_dataset/splits"))
    splits.mkdir(parents=True, exist_ok=True)
    parts = {"train": df.iloc[:6], "valid": df.iloc[6:9], "test": df.iloc[9:]}
    for name, part in parts.items():
        part.to_csv(splits / f"{name}.csv", index=False)
    parts["test"].to_csv(splits / "images_to_avoid.csv", index=False)
    gold = pd.DataFrame([r for r in gold_rows
                         if r["image_id"][:-4] in set(parts["test"].dicom_id)])
    gold_dir = Path(imagenome.get_full_path("gold_dataset"))
    gold_dir.mkdir(parents=True, exist_ok=True)
    gold.to_csv(gold_dir / tm.GOLD_OBJECTS_FILE, sep="\t", index=False)
    return {"mimic": str(mimic_dir), "imagenome": str(imagenome_dir), "records": df}


@pytest.fixture
def mirrors(tmp_path):
    """The same mirror twice: JAX's copy and the port's."""
    out = {"jax": write_mirror(tmp_path / "jax")}
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    out["port"] = {k: (v.replace(str(tmp_path / "jax"), str(tmp_path / "port"))
                       if isinstance(v, str) else v) for k, v in out["jax"].items()}
    return out


def _filers(mod, m):
    return mod.MimicCxrFiler(m["mimic"]), mod.ImaGenomeFiler(m["imagenome"])


def _assert_items_equal(got: dict, ref: dict) -> None:
    assert sorted(got) == sorted(ref)
    for k, r in ref.items():
        if k == "image":
            assert got[k].dtype == r.dtype and np.array_equal(got[k], r)
        else:
            assert got[k] == r, k


# ---- objects, sentences, items ---------------------------------------------------

@pytest.mark.parametrize("gold", [False, True], ids=["silver", "gold"])
def test_objects_and_sentences_match_jax(mirrors, gold):
    (_, ji), (_, ti) = _filers(jm, mirrors["jax"]), _filers(tm, mirrors["port"])
    records = mirrors["jax"]["records"]
    if gold:
        records = records.iloc[9:]
    jg = ji.get_gold_file(tm.GOLD_OBJECTS_FILE) if gold else None
    tg = ti.get_gold_file(tm.GOLD_OBJECTS_FILE) if gold else None
    for dicom in records.dicom_id:
        for fix in (False, True):
            ref = jm.get_objects(dicom, gold, jg, ji, fix_coord_bug=fix)
            got = tm.get_objects(dicom, gold, tg, ti, fix_coord_bug=fix)
            assert got == ref and got["sent_to_bboxes"]
    ref = jm.build_sentences_df(records, ji, gold, jg)
    got = tm.build_sentences_df(records, ti, gold, tg)
    assert len(got) > 2 * len(records)
    pd.testing.assert_frame_equal(got, ref)
    # the reference's silver wart: the y2 slot holds x2
    if not gold:
        info = next(iter(tm.get_objects("d0000", False, None, ti)["sent_to_bboxes"].values()))
        x1, y1, x2, y2 = info["coords_original"][0]
        assert y2 == x2
    # the row selectors on the table's rows
    names = ast.literal_eval(got.iloc[0]["bbox_names"])

    def selections(mod):
        sels = (mod.RowBBoxSelector(contains=names), mod.RowBBoxSelector(does_not_contain=names),
                mod.RowBBoxSelector(contains=names, only_contains=True),
                mod.RowLabelAndContextSelector(contains=[(CONDITIONS[0], "yes")]),
                mod.OrSelector(mod.RowBBoxSelector(contains=["mediastinum"]),
                               mod.RowBBoxSelector(contains=["left lung"])))
        return [[bool(sel(r)) for _, r in got.iterrows()] for sel in sels]

    assert selections(tm) == selections(jm)


PERTURBATIONS = {  # the ImaGenomeDataset options each case sets
    "plain": {},
    "random_bboxes": {"randomize_objects_mode": "random_bboxes"},
    "random_sentences": {"randomize_objects_mode": "random_sentences"},
    "shuffle": {"randomize_objects_mode": "shuffle"},
    "swap_left_right": {"swap_left_right": True},
    "generate_sent": {"generate_sent": True},
    "swap_conditions": {"generate_sent": True, "swap_conditions": True},
    "mask_word": {"mask": "word", "prob_of_masking": 0.5},
    "mask_entity": {"mask": "clinical_entity", "prob_of_masking": 1},
    "group_by_image_random_reports": {"group_by": "image", "randomize_reports": True},
    "group_by_study": {"group_by": "study"},
    "selector_sample": {"num_rand_sent": 5, "selector": True},
}


def _dataset(mod, m, gold: bool, opts: dict, seed: int):
    filer, imagenome = _filers(mod, m)
    records = m["records"].iloc[9:] if gold else m["records"]
    gold_df = imagenome.get_gold_file(tm.GOLD_OBJECTS_FILE) if gold else None
    kw = {k: v for k, v in opts.items() if k not in ("mask", "selector")}
    if opts.get("mask"):
        kw["text_masker"] = mod.build_masker(opts["mask"], mask_prob=0.3, rng=random.Random(seed + 1))
    if opts.get("selector"):
        kw["sentence_selector"] = mod.RowBBoxSelector(does_not_contain=["mediastinum"])
    if opts.get("swap_conditions"):
        plain = mod.ImaGenomeDataset(records, filer, imagenome, gold=gold,
                                     sentences_df=mod.build_sentences_df(records, imagenome, gold,
                                                                         gold_df))
        kw["valid_locations_conditions"] = mod.save_and_get_all_location_condition_pairs(
            plain, imagenome.get_full_path("location_condition_pairs.pkl"))
    sentences = mod.build_sentences_df(records, imagenome, gold, gold_df)
    return mod.ImaGenomeDataset(records, filer, imagenome, gold=gold, sentences_df=sentences,
                                rng=random.Random(seed), **kw)


@pytest.mark.parametrize("gold", [False, True], ids=["silver", "gold"])
@pytest.mark.parametrize("case", list(PERTURBATIONS))
def test_dataset_items_match_jax(mirrors, case, gold):
    """Every item of every perturbation, twice through (the shared ``rng``
    goes on drawing), equals JAX's; the perturbation did something."""
    opts = PERTURBATIONS[case]
    ref_ds = _dataset(jm, mirrors["jax"], gold, opts, seed=3)
    ds = _dataset(tm, mirrors["port"], gold, opts, seed=3)
    assert len(ds) == len(ref_ds) > 0
    for _ in range(2):
        for i in range(len(ds)):
            _assert_items_equal(ds[i], ref_ds[i])
    if case != "plain":
        plain = _dataset(tm, mirrors["port"], gold, {"group_by": opts.get("group_by", "sentence")},
                         seed=3)
        changed = [ds[i]["report"] != plain[i]["report"]
                   or ds[i]["objects"] != plain[i]["objects"] for i in range(min(len(ds), 6))]
        assert any(changed) or opts.get("group_by") == "study" or "selector" in opts


def test_missing_mirror_files_name_the_roadmap_item(tmp_path):
    filer = tm.MimicCxrFiler(str(tmp_path / "m"))
    with pytest.raises(NotImplementedError, match="ROADMAP.md A6.2"):
        filer.get_image("nope")
    with pytest.raises(NotImplementedError, match="ROADMAP.md A6.2"):
        filer.get_report(10000, 50000)


def test_split_subjects_and_record_filters_match_jax(mirrors):
    for seed in (0, 3):
        assert tm.split_subjects(range(57), seed=seed) == jm.split_subjects(range(57), seed=seed)
    df = mirrors["jax"]["records"]
    for filters in ([tm.ViewpointFilter()], [tm.HasGreaterThanNStudies(1)],
                    [tm.ViewpointFilter(("AP",)), tm.HasGreaterThanNStudies(1)]):
        jfilters = [getattr(jm, type(f).__name__)(**vars(f)) for f in filters]
        pd.testing.assert_frame_equal(tm.process_records(df, filters),
                                      jm.process_records(df, jfilters))
    gen, jgen = tm.GenerateContextLocationConditionSentences(), jm.GenerateContextLocationConditionSentences()
    for args in ((["edema", "edema"], ["yes", "yes"], ["left lung", "right lung"]),
                 (["normal"] * 3, ["yes"] * 3, ["mediastinum", "left lung", "right lung"]),
                 (["a", "b"], ["no", "yes"], ["x", "y"])):
        assert gen(*args) == jgen(*args)
    assert tm.swap_left_right_words("Left base, RIGHT apex") == jm.swap_left_right_words(
        "Left base, RIGHT apex") == "right base, left apex"


# ---- maskers ----------------------------------------------------------------------

TEXTS = ["There is a small left pleural effusion with basilar atelectasis.",
         "No pneumothorax. Mild pulmonary edema/hazy opacity has worsened! Stable heart.",
         "single", "",
         "Tortuous aorta without mediastinal widening. Endotracheal tube 4 cm above the carina."]


@pytest.mark.parametrize("mode", ["word", "sentence", "entity", "clinical_entity", "all"])
def test_maskers_match_jax(mode):
    for prob in (0.15, 0.5, 1.0):
        got = ttm.build_masker(mode, mask_prob=prob, rng=random.Random(7))
        ref = jtm.build_masker(mode, mask_prob=prob, rng=random.Random(7))
        assert [got(t) for t in TEXTS * 3] == [ref(t) for t in TEXTS * 3]
    assert ttm._CLINICAL_PHRASES == jtm._CLINICAL_PHRASES
    assert ttm._CLINICAL_RE.pattern == jtm._CLINICAL_RE.pattern


# ---- the data module --------------------------------------------------------------

def _module_cfg(m: dict, **data) -> dict:
    return {
        "phase": "pretrain",
        "random_seed": 5,
        "model": {"text": {}},
        "data": {"dataset": "imagenome", "group_by": "sentence", "gold_test": True,
                 "mimic_cxr_download_directory": m["mimic"],
                 "imagenome_download_directory": m["imagenome"],
                 "image": {"imsize": 64}, "text": {"word_num": 24}, **data},
        "transforms": {"norm": "half", "random_crop": {"crop_size": 48}},
        "train": {"batch_size": 4, "num_workers": 1},
    }


def _host_batches(loader) -> list[dict]:
    return [{k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                 if not k.startswith("_") else v) for k, v in b.items()} for b in loader]


@pytest.mark.parametrize("data", [{}, {"swap_left_right": True, "mask_mode": "word",
                                       "prob_of_masking": 0.5}],
                         ids=["plain", "swap_and_mask"])
def test_data_module_batches_match_jax(mirrors, data):
    """``build_data_module`` on each mirror: the vocabulary from the corpus,
    then every batch of each split (one builder: ``prefetch=1``, one
    worker) equal to JAX's, host keys included.  A masker built without an
    ``rng`` draws from the global ``random``, as in JAX: it is seeded the
    same before each side."""
    random.seed(11)
    jmod = jdm.build_data_module(JConfig(_module_cfg(mirrors["jax"], **data)))
    random.seed(11)
    tmod = tdm.build_data_module(TConfig(_module_cfg(mirrors["port"], **data)), device="cpu")
    assert isinstance(tmod, tm.ImaGenomeDataModule)
    assert tmod.tokenizer.vocab == jmod.tokenizer.vocab
    for split in ("train", "valid", "test"):
        random.seed(12)
        ref = _host_batches(jmod.loader(split, prefetch=1))
        random.seed(12)
        got = _host_batches(tmod.loader(split, prefetch=1))
        assert len(got) == len(ref) > 0
        for g, r in zip(got, ref):
            assert sorted(g) == sorted(r) and "segmentation_labels" in g
            for k, rv in r.items():
                gv = g[k]
                if k in ("_words", "_ids"):
                    assert list(gv) == list(rv), k
                elif k in ("caption_ids", "attention_mask", "token_type_ids", "cap_lens"):
                    assert np.array_equal(gv.astype(np.int64), rv.astype(np.int64)), k
                else:
                    assert gv.dtype == rv.dtype and np.array_equal(gv, rv), k
        assert any(b["segmentation_labels"].sum() > 0 for b in got)


# ---- metrics ----------------------------------------------------------------------

def _overlays(seed: int, B: int = 5, side: int = 6, H: int = 48):
    rng = np.random.RandomState(seed)
    grid = rng.dirichlet(np.ones(side * side), size=B).reshape(B, side, side) * 0.9
    grid[1] = np.round(grid[1] * 40) / 40  # ties
    overlays = np.stack([tloc.get_attn_overlay(g, (H, H)) for g in grid]).astype(np.float32)
    labels = np.zeros((B, H, H), np.float32)
    for i in range(B):
        x, y = rng.randint(0, H - 10, 2)
        labels[i, y : y + rng.randint(3, 20), x : x + rng.randint(3, 20)] = 1
    labels[2] = 0  # an empty label
    labels[3] = 1  # no negative pixel
    return overlays, labels, grid


def test_localization_metrics_match_jax():
    overlays, labels, grid = _overlays(0)
    for p in (0.0, 0.05, 0.1, 0.3, 0.99):
        got = tmet.topk_overlap_metrics(torch.from_numpy(overlays.reshape(5, -1)),
                                        torch.from_numpy(labels.reshape(5, -1)), p)
        ref = jmet.topk_overlap_metrics(jnp.asarray(overlays.reshape(5, -1)),
                                        jnp.asarray(labels.reshape(5, -1)), p)
        for k in ref:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=f"{p} {k}")
    dist = np.random.RandomState(1).dirichlet(np.ones(9), size=4)
    dist[0, 0] = 0
    np.testing.assert_array_equal(tmet.attention_entropy_np(dist), jmet.attention_entropy_np(dist))
    got = tloc.batch_localization_metrics(overlays, labels, grid)
    ref = jloc.batch_localization_metrics(overlays, labels, grid)
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        atol = 1e-6 if k in ("auroc", "avg_precision") else 0
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=atol, equal_nan=True, err_msg=k)
    assert np.isnan(got["auroc"][2]) and np.isnan(got["auroc"][3]) and np.isfinite(got["auroc"][0])
    attn = np.random.RandomState(2).rand(3, 7, 36).astype(np.float32)
    cap_lens = np.asarray([1, 4, 7])
    np.testing.assert_array_equal(tloc.sentence_attention(torch.from_numpy(attn), cap_lens, (6, 6)),
                                  jloc.sentence_attention(attn, cap_lens, (6, 6)))


def test_curves_match_sklearn():
    from sklearn.metrics import precision_recall_curve, roc_curve

    overlays, labels, _ = _overlays(3)
    rng = np.random.RandomState(4)
    cases = [(labels[i].reshape(-1), overlays[i].reshape(-1)) for i in (0, 1, 3, 4)]
    cases += [((rng.rand(200) < 0.3).astype(np.float32), np.round(rng.rand(200) * 8).astype(np.float32)),
              (np.asarray([0, 1, 1, 0], np.float32), np.asarray([0.5, 0.5, 0.5, 0.5], np.float32)),
              (np.asarray([1.0]), np.asarray([0.2]))]
    with np.errstate(all="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore")  # sklearn warns of single-class labels
        for y, s in cases:
            for ours, theirs in ((tmet.roc_curve, roc_curve),
                                 (tmet.precision_recall_curve, precision_recall_curve)):
                got, ref = ours(y, s), theirs(y, s)
                for g, r in zip(got, ref):
                    assert g.dtype == r.dtype and g.shape == r.shape
                    np.testing.assert_array_equal(g, r)


# ---- the callbacks ----------------------------------------------------------------

class _Logger:
    def __init__(self):
        self.rows, self.hists = [], []

    def log(self, metrics, step, split="train"):
        self.rows.append((split, step, dict(metrics)))

    def log_histogram(self, name, values, step):
        self.hists.append((name, np.asarray(values).copy(), step))


class _Trainer:
    def __init__(self):
        self.logger, self.global_step = _Logger(), 7


def _callback_batch(seed: int, B: int = 6, W: int = 8, side: int = 5, H: int = 40):
    rng = np.random.RandomState(seed)
    attn = rng.dirichlet(np.ones(side * side), size=(B, W)).astype(np.float32) * 0.95
    labels = np.zeros((B, H, H), np.float32)
    for i in range(B - 1):
        x, y = rng.randint(0, H - 12, 2)
        labels[i, y : y + 12, x : x + 9] = 1
    batch = {"segmentation_labels": labels, "cap_lens": rng.randint(1, W, B),
             "imgs": rng.rand(B, H, H, 3).astype(np.float32),
             "_ids": [f"dicom_d{seed}{i}_sent_s/{i}" for i in range(B)],
             "_words": [["[CLS]", "left", "lung", f"w{i}", "[SEP]"] for i in range(B)],
             "_indices": rng.permutation(20)[:B]}
    metrics = {"_attn": attn, "_local_sims": rng.randn(B).astype(np.float32),
               "_global_sims": rng.randn(B).astype(np.float32)}
    return metrics, batch


_STEP_OUTPUTS = ("_attn", "_local_sims", "_global_sims")


def _port_view(metrics: dict, batch: dict) -> tuple[dict, dict]:
    """What the port's trainer hands its callbacks: the step's outputs and
    the batch's arrays as tensors, the collate's host keys as they are."""
    def tensors(d: dict) -> dict:
        return {k: torch.from_numpy(np.asarray(v)) if k in _STEP_OUTPUTS or not k.startswith("_")
                else v for k, v in d.items()}

    return tensors(metrics), tensors(batch)


@pytest.mark.parametrize("mode", ["upsample", "pyramid", "windows"])
def test_evaluate_localization_matches_jax(tmp_path, mode):
    """Two batches through each callback's hooks (train, validation, test):
    the port's per-split CSVs hold JAX's rows (JAX files the validation rows
    under train/), its artifacts equal JAX's, and the logged means agree."""
    cfg = {"data": {"gold_test": True}}
    ref_cb = jloc.EvaluateLocalization(JConfig(cfg), save_dir=tmp_path / "jax",
                                       eval_attn_overlay_mode=mode, log_train_every=1,
                                       save_full_data=True)
    cb = tloc.EvaluateLocalization(TConfig(cfg), save_dir=tmp_path / "port",
                                   eval_attn_overlay_mode=mode, log_train_every=1,
                                   save_full_data=True)
    jt, tt = _Trainer(), _Trainer()
    for hook, seed in (("on_train_batch_end", 0), ("on_validation_batch_end", 1),
                       ("on_test_batch_end", 2)):
        metrics, batch = _callback_batch(seed)
        getattr(ref_cb, hook)(jt, None, metrics, batch, 0)
        getattr(cb, hook)(tt, None, *_port_view(metrics, batch), 0)
        if hook == "on_validation_batch_end":
            ref_cb.on_epoch_end(jt, None, "train", {})
            cb.on_epoch_end(tt, None, "train", {})
    ref_cb.on_epoch_end(jt, None, "test", {})
    cb.on_epoch_end(tt, None, "test", {})
    assert [(s, st, sorted(m)) for s, st, m in tt.logger.rows] == \
           [(s, st, sorted(m)) for s, st, m in jt.logger.rows]
    for (_, _, g), (_, _, r) in zip(tt.logger.rows, jt.logger.rows):
        np.testing.assert_allclose([g[k] for k in r], list(r.values()), rtol=0, atol=1e-6)
    port = {s: pd.read_csv(tmp_path / "port" / s / "sentences.csv") for s in ("train", "val", "test")}
    ref = {s: pd.read_csv(tmp_path / "jax" / s / "sentences.csv") for s in ("train", "test")}
    assert not (tmp_path / "jax" / "val").exists()
    for got, want in ((pd.concat([port["train"], port["val"]], ignore_index=True), ref["train"]),
                      (port["test"], ref["test"])):
        _assert_sentences_close(got, want, {"auroc": 1e-6, "avg_precision": 1e-6}, default=0)
    for split, jsplit in (("train", "train"), ("val", "train"), ("test", "test")):
        for path in sorted((tmp_path / "port" / split).rglob("*.np*")):
            twin = tmp_path / "jax" / jsplit / path.relative_to(tmp_path / "port" / split)
            g, r = np.load(path), np.load(twin)
            if path.suffix == ".npz":
                assert sorted(g.files) == sorted(r.files)
                for f in r.files:
                    assert g[f].dtype == r[f].dtype and np.array_equal(g[f], r[f], equal_nan=True)
            else:
                assert g.dtype == r.dtype and np.array_equal(g, r)
    assert len(list((tmp_path / "port" / "val" / "roc_curve").iterdir())) == 6


def _assert_sentences_close(got: pd.DataFrame, want: pd.DataFrame, atol: dict, default: float):
    assert list(got.columns) == list(want.columns) and len(got) == len(want) > 0
    assert got["dicom_sent_id"].tolist() == want["dicom_sent_id"].tolist()
    assert got["sentence"].fillna("").tolist() == want["sentence"].fillna("").tolist()
    for col in want.columns[2:]:
        tol = atol.get(col, atol.get(col.split("_at_")[0] + "_at", default))
        np.testing.assert_allclose(got[col].to_numpy(float), want[col].to_numpy(float),
                                   rtol=0, atol=tol, equal_nan=True, err_msg=col)


@pytest.mark.parametrize("weight_mode", ["attn_entropy", "no_attn_score"])
def test_weight_instances_matches_jax(weight_mode):
    class Loader:
        sample_weights = None

    ref_loader, loader = Loader(), Loader()
    ref_cb = jloc.WeightInstancesByLocalization(ref_loader, 20, weight_mode=weight_mode, temp=0.3)
    cb = tloc.WeightInstancesByLocalization(loader, 20, weight_mode=weight_mode, temp=0.3)
    jt, tt = _Trainer(), _Trainer()
    for seed in range(3):
        metrics, batch = _callback_batch(seed)
        ref_cb.on_train_batch_end(jt, None, metrics, batch, seed)
        cb.on_train_batch_end(tt, None, *_port_view(metrics, batch), seed)
    ref_cb.on_epoch_end(jt, None, "train", {})
    cb.on_epoch_end(tt, None, "train", {})
    np.testing.assert_allclose(loader.sample_weights, ref_loader.sample_weights, rtol=0, atol=1e-12)
    assert abs(loader.sample_weights.sum() - 1) < 1e-12
    assert [h[0] for h in tt.logger.hists] == ["train/weights_hist", "train/weights_softmax_hist"]
    for (_, g, _), (_, r, _) in zip(tt.logger.hists, jt.logger.hists):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-12)


# ---- the train step's attention outputs --------------------------------------------

def test_train_step_attention_matches_jax():
    """JAX's train step with ``return_attn=True`` and the port's, from JAX's
    weights on one batch with boxes: the same metrics, and ``_attn``,
    ``_local_sims``, ``_global_sims`` within the stated tolerances.  Without
    ``return_attn`` the port's step returns none of them."""
    from _tiny import tiny_batch, tiny_cfg, tiny_setup

    overrides = {"model.gloria.segmentation_loss_weight": 1.0}
    _, j_state, j_step, _ = tiny_setup(overrides, return_attn=True)
    batch = tiny_batch(seed=3)
    labels = np.zeros((8, 64, 64), np.float32)
    labels[:, 10:40, 5:30] = 1
    batch["segmentation_labels"] = labels
    variables = jax.device_get({"params": j_state.params, "batch_stats": j_state.batch_stats})
    cfg = TConfig(tiny_cfg(overrides).to_dict())
    from gloria_tpu_torch.models.gloria_model import GLoRIA

    model = GLoRIA(cfg)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    opt = optim.make_optimizer(cfg, grad_clip=cfg.lightning.trainer.gradient_clip_val)
    state = train.create_train_state(model, opt, seed=0, device="cpu")
    t_step, _ = train.make_pretrain_steps(model, opt, return_attn=True)
    _, ref = j_step(j_state, batch)
    _, got = t_step(state, batch)
    assert set(got) == set(ref)
    for k, tol in (("_attn", 1e-4), ("_local_sims", 1e-4), ("_global_sims", 1e-4)):
        g, r = got[k].numpy(), np.asarray(ref[k])
        assert g.shape == r.shape and not got[k].requires_grad
        np.testing.assert_allclose(g, r, rtol=0, atol=tol, err_msg=k)
    for k in ("loss", "attn_seg_loss"):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=STEP_RTOL)
    plain_step, _ = train.make_pretrain_steps(model, opt)
    _, plain = plain_step(state, batch)
    assert not any(k.startswith("_") for k in plain)


# ---- the whole driver against JAX's run.py ------------------------------------------

_JAX_RUN = """
import pickle, sys
import jax
jax.config.update("jax_platforms", "cpu")
repo, cfg, out, export, *flags = sys.argv[1:]
sys.path.insert(0, repo)
from gloria_tpu import builder
_init = builder.init_gloria
def init_and_export(*a, **kw):
    res = _init(*a, **kw)
    with open(export, "wb") as fh:
        pickle.dump(jax.device_get({"params": res[1].params,
                                    "batch_stats": res[1].batch_stats}), fh)
    return res
builder.init_gloria = init_and_export
sys.argv = ["run.py", "-c", cfg, "--train", "--test", "--output_dir", out, *flags]
exec(compile(open(repo + "/run.py").read(), "run.py", "exec"), {"__name__": "__main__"})
"""


def _driver_cfg(m: dict) -> dict:
    return {
        "experiment_name": "grounding",
        "phase": "pretrain",
        "random_seed": 0,
        "lightning": {
            "trainer": {"max_epochs": 2, "gradient_clip_val": 0.25, "lr": 0.01, "precision": 32},
            "checkpoint_callback": {"monitor": "val_loss", "save_last": True, "mode": "min",
                                    "save_top_k": 1},
            "evaluate_localization": {"eval_attn_overlay_mode": "upsample", "log_train_every": 1},
            "weight_instances_by_localization": {"weight_mode": "attn_entropy", "temp": 0.2},
        },
        "model": {
            "gloria": {"temp1": 4.0, "temp2": 5.0, "temp3": 10.0, "segmentation_loss_weight": 1.0},
            "vision": {"model_name": "resnet_18"},
            "text": {"embedding_dim": 32, "last_n_layers": 4, "agg_tokens": True,
                     "aggregate_method": "sum",
                     "bert_config": {"vocab_size": 256, "hidden_size": 32, "num_layers": 1,
                                     "num_heads": 4, "intermediate_size": 64,
                                     "max_position_embeddings": 48, "dropout_rate": 0.0}},
        },
        # no transforms.random_crop: the train transform draws nothing
        "data": {"dataset": "imagenome", "group_by": "sentence", "gold_test": True,
                 "mimic_cxr_download_directory": m["mimic"],
                 "imagenome_download_directory": m["imagenome"],
                 "text": {"word_num": 24}, "image": {"imsize": 64}},
        "transforms": {"norm": "half"},
        "train": {"update_interval": 1, "batch_size": 8, "num_workers": 2,
                  "optimizer": {"name": "SGD", "weight_decay": "1e-6"},
                  "scheduler": {"name": "step", "monitor": "val_loss"}},
    }


def _run_dir(base: Path) -> Path:
    (d,) = [p for p in base.iterdir() if p.is_dir()]
    return d


def test_driver_matches_jax_run(mirrors, tmp_path):
    """``run.py`` (in a process of its own on one CPU device, as the JAX
    driver runs) and the port's driver in this process, on their copies of
    the mirror, with both localization callbacks: per-epoch and test losses,
    and each split's ``sentences.csv`` (artifacts too on the gold test
    split)."""
    paths = {}
    for side in ("jax", "port"):
        paths[side] = tmp_path / f"{side}.yaml"
        paths[side].write_text(yaml.safe_dump(_driver_cfg(mirrors[side]), sort_keys=False))
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "PYTHONPATH")}
    env["JAX_PLATFORMS"] = "cpu"
    env["GLORIA_COMPILE_CACHE"] = str(tmp_path / "jax_cache")  # run.py's own cache, kept here
    export = tmp_path / "jax_init.pkl"
    flags = ["--limit_batches", "1"]  # one train, validation and test batch an epoch
    proc = subprocess.run([sys.executable, "-c", _JAX_RUN, str(ROOT), str(paths["jax"]),
                           str(tmp_path / "jax_out"), str(export), *flags],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    from gloria_tpu_torch.training.checkpoints import save_checkpoint

    with open(export, "rb") as fh:
        save_checkpoint(tmp_path / "init", {"model": state_dict_from_jax(pickle.load(fh))})
    assert run.cli(["-c", str(paths["port"]), "--train", "--test", "--device", "cpu",
                    "--output_dir", str(tmp_path / "port_out"), "--ckpt",
                    str(tmp_path / "init"), *flags]) == 0

    jdir, tdir = _run_dir(tmp_path / "jax_out"), _run_dir(tmp_path / "port_out")
    # the localization means are each split's first logged row, so they set
    # metrics_<split>.csv's header in both drivers, and the losses go whole
    # to metrics_<split>.jsonl
    for name, keys in (("metrics_epoch.csv", ("train_loss", "val_loss")),
                       ("metrics_train.jsonl", ("loss", "attn_seg_loss")),
                       ("metrics_test.jsonl", ("test_loss", "test_attn_seg_loss"))):
        read = pd.read_csv if name.endswith(".csv") else lambda p: pd.read_json(p, lines=True)
        jrows, trows = read(jdir / name), read(tdir / name)
        if "loss" in keys:
            jrows, trows = jrows.dropna(subset=["loss"]), trows.dropna(subset=["loss"])
        assert len(trows) == len(jrows) > 0 and list(trows["step"]) == list(jrows["step"])
        for k in keys:
            np.testing.assert_allclose(trows[k], jrows[k], rtol=STEP_RTOL, err_msg=f"{name} {k}")
    # the second epoch drew its items by the first one's weights
    assert [h["name"] for h in map(json.loads, open(tdir / "histograms.jsonl"))] == \
        [h["name"] for h in map(json.loads, open(jdir / "histograms.jsonl"))]
    loc, jloc_dir = tdir / "localization", jdir / "localization"
    port = {s: pd.read_csv(loc / s / "sentences.csv") for s in ("train", "val", "test")}
    atol = {"local_sims": 1e-3, "global_sims": 1e-3, "auroc": 2e-3, "avg_precision": 2e-3,
            "attn_entropy": 1e-4, "no_attn_weight": 1e-4}
    _assert_sentences_close(pd.concat([port["train"], port["val"]], ignore_index=True),
                            pd.read_csv(jloc_dir / "train" / "sentences.csv"), atol, TOPK_ATOL)
    _assert_sentences_close(port["test"], pd.read_csv(jloc_dir / "test" / "sentences.csv"), atol,
                            TOPK_ATOL)
    assert np.isfinite(port["test"]["auroc"]).all()
    for folder in ("attn", "image", "label", "roc_curve", "pr_curve"):
        got = sorted(p.name for p in (loc / "test" / folder).iterdir())
        assert got == sorted(p.name for p in (jloc_dir / "test" / folder).iterdir())
        assert len(got) == len(port["test"])
    for path in (loc / "test" / "attn").iterdir():
        np.testing.assert_allclose(np.load(path), np.load(jloc_dir / "test" / "attn" / path.name),
                                   rtol=0, atol=1e-5)
