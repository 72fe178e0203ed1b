"""MIMIC-CXR + Chest ImaGenome: the grounding dataset and its perturbations.

The port's own copy of the read side of ``gloria_tpu.data.mimic`` (the
reference's ``gloria/datasets/mimic_data.py``), over a PhysioNet mirror
already on disk:

- :class:`MimicCxrFiler`: the mirror's report and cached-image paths
  (``files/p<xx>/p<subject>/s<study>.txt``, ``image_cache/<dicom>.npy``);
- the record filters (PA/AP viewpoints, more than N studies) and the
  patient-level :func:`split_subjects`;
- :class:`ImaGenomeFiler`: the split tables, the gold table, the silver
  scene graphs and the per-dicom objects cache (``objects/<dicom>.pkl``);
- :func:`get_objects` / :func:`update_objects`: a scene graph (or the gold
  table) → the ``bbox_to_sents`` / ``sent_to_bboxes`` index.  The
  reference builds a silver box as ``[x1, y1, x2, x2]`` (its y2 slot takes
  x2); that stays behind ``fix_coord_bug=False``, as in JAX;
- :class:`ImaGenomeDataset`: grouping by sentence, image, study or
  patient, gold or silver, and every perturbation: object randomization
  (random boxes, random sentences, shuffle), the left↔right word swap,
  template sentences from (condition, context, location) triples,
  condition swapping, random reports and the masking hook;
- the row selectors, :func:`build_sentences_df` and
  :class:`ImaGenomeDataModule`.

Not ported (ROADMAP.md A6.2): the PhysioNet download, the DICOM → NIfTI →
array conversion and its parallel driver.  A report or cached image missing
from the mirror raises ``NotImplementedError``, where JAX would fetch it
with wget.  pandas is imported inside the functions that use it.
"""

from __future__ import annotations

import ast
import json
import os
import pickle
import random

import numpy as np

from ..configs import Config
from .data_module import _PretrainModule
from .text_masking import build_masker

GOLD_OBJECTS_FILE = "gold_object_attribute_with_coordinates.txt"


def _not_in_mirror(path: str) -> NotImplementedError:
    return NotImplementedError(
        f"{path} is not in the PhysioNet mirror, and fetching it (the PhysioNet download "
        "and the DICOM conversion) is not ported yet (queued in ROADMAP.md A6.2)")


class PhysioNetFiler:
    """A PhysioNet project's mirror: ``<download_directory>/physionet.org/
    files/<project>/<version>/``."""

    base_url: str = ""
    default_dir: str = ""

    def __init__(self, download_directory: str | None = None):
        self.download_directory = download_directory or os.path.join(os.getcwd(), self.default_dir)
        os.makedirs(self.download_directory, exist_ok=True)
        self.full_download_directory = os.path.join(
            self.download_directory, "physionet.org/files",
            self.base_url.rstrip("/").split("/files/")[-1])

    def get_full_path(self, path: str) -> str:
        return os.path.join(self.full_download_directory, path)


class MimicCxrFiler(PhysioNetFiler):
    base_url = "https://physionet.org/files/mimic-cxr/2.0.0"
    default_dir = "mimic-cxr"

    def report_relpath(self, subject_id, study_id) -> str:
        return f"files/p{str(subject_id)[:2]}/p{subject_id}/s{study_id}.txt"

    def image_cache_path(self, dicom_id) -> str:
        return self.get_full_path(f"image_cache/{dicom_id}.npy")

    def get_report(self, subject_id, study_id) -> str:
        path = self.get_full_path(self.report_relpath(subject_id, study_id))
        if not os.path.exists(path):
            raise _not_in_mirror(path)
        with open(path, errors="ignore") as fh:
            return fh.read()

    def get_image(self, dicom_id) -> np.ndarray:
        path = self.image_cache_path(dicom_id)
        if not os.path.exists(path):
            raise _not_in_mirror(path)
        return np.load(path)


# -- record filters ----------------------------------------------------------

class ViewpointFilter:
    def __init__(self, viewpoints=("PA", "AP")):
        self.viewpoints = set(viewpoints)

    def __call__(self, records):
        return records[records.ViewPosition.isin(self.viewpoints)]


class HasGreaterThanNStudies:
    def __init__(self, n: int = 1):
        self.n = n

    def __call__(self, records):
        counts = records.groupby("subject_id").study_id.nunique()
        keep = counts[counts > self.n].index
        return records[records.subject_id.isin(keep)]


def process_records(records, filters=()):
    for f in filters:
        records = f(records)
    return records


def split_subjects(subject_ids, ratios=(0.8, 0.1, 0.1), seed: int = 0) -> dict:
    """Patient-level train / valid / test split of the subject ids."""
    rng = np.random.RandomState(seed)
    ids = np.asarray(sorted(set(subject_ids)))
    rng.shuffle(ids)
    n = len(ids)
    n_train = int(n * ratios[0])
    n_valid = int(n * ratios[1])
    return {
        "train": set(ids[:n_train].tolist()),
        "valid": set(ids[n_train : n_train + n_valid].tolist()),
        "test": set(ids[n_train + n_valid :].tolist()),
    }


class ImaGenomeFiler(PhysioNetFiler):
    base_url = "https://physionet.org/files/chest-imagenome/1.0.0"
    default_dir = "chest-imagenome"

    def get_split(self, split: str):
        import pandas as pd

        if split in ("train", "valid", "test"):
            return pd.read_csv(self.get_full_path(f"silver_dataset/splits/{split}.csv"))
        if split == "gold":
            return pd.read_csv(self.get_full_path("silver_dataset/splits/images_to_avoid.csv"))
        raise ValueError(split)

    def get_gold_file(self, file: str):
        import pandas as pd

        if not file.endswith(".txt"):
            raise ValueError(file)
        return pd.read_csv(self.get_full_path(os.path.join("gold_dataset", file)), sep="\t")

    def get_silver_scene_graph_json_file(self, dicom_id) -> str:
        return self.get_full_path(f"silver_dataset/scene_graph/{dicom_id}_SceneGraph.json")

    def get_silver_scene_graph_json(self, dicom_id) -> dict:
        with open(self.get_silver_scene_graph_json_file(dicom_id)) as fh:
            return json.load(fh)

    def get_objects_file(self, dicom_id) -> str:
        return self.get_full_path(f"objects/{dicom_id}.pkl")

    def save_objects(self, obj, dicom_id) -> None:
        path = self.get_objects_file(dicom_id)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as fh:
            pickle.dump(obj, fh)

    def get_objects(self, dicom_id) -> dict:
        with open(self.get_objects_file(dicom_id), "rb") as fh:
            return pickle.load(fh)

    def has_objects(self, dicom_id) -> bool:
        return os.path.exists(self.get_objects_file(dicom_id))


# -- scene graph → objects index --------------------------------------------

def update_objects(objects, bbox, coord_original, sentence_id, sentence, label, context):
    sent_info = objects["bbox_to_sents"].setdefault(bbox, {
        "coord_original": coord_original, "sentence_ids": [], "sentences": [],
        "labels": [], "contexts": [],
    })
    sent_info["sentence_ids"].append(sentence_id)
    sent_info["sentences"].append(sentence)
    sent_info["labels"].append(label)
    sent_info["contexts"].append(context)
    bbox_info = objects["sent_to_bboxes"].setdefault(sentence_id, {
        "sentence": sentence, "bboxes": [], "coords_original": [],
        "labels": [], "contexts": [],
    })
    bbox_info["bboxes"].append(bbox)
    bbox_info["coords_original"].append(coord_original)
    bbox_info["labels"].append(label)
    bbox_info["contexts"].append(context)


def get_objects(dicom_id, gold: bool, gold_objects_df=None, imagenome_filer=None,
                fix_coord_bug: bool = False) -> dict:
    """The objects index of one image, from the gold table or its silver
    scene graph (empty when the image has none)."""
    objects = {"bbox_to_sents": {}, "sent_to_bboxes": {}}
    if gold:
        assert gold_objects_df is not None
        rows = gold_objects_df[gold_objects_df.image_id.str.replace(".dcm", "", regex=False) == dicom_id]
        for _, row in rows.iterrows():
            coord = row.coord_original
            if isinstance(coord, str):
                coord = json.loads(coord.replace("(", "[").replace(")", "]"))
            update_objects(objects, bbox=row.bbox, coord_original=coord,
                           sentence_id=row.row_id, sentence=row.sentence,
                           label=row.label_name, context=row.context)
        return objects

    assert imagenome_filer is not None
    if not os.path.exists(imagenome_filer.get_silver_scene_graph_json_file(dicom_id)):
        return objects
    scene_graph = imagenome_filer.get_silver_scene_graph_json(dicom_id)
    temp_objects = {obj["object_id"]: obj for obj in scene_graph["objects"]}
    for bbox_attributes in scene_graph["attributes"]:
        if bbox_attributes["object_id"] not in temp_objects:
            continue
        obj = temp_objects[bbox_attributes["object_id"]]
        y2 = obj["original_y2"] if fix_coord_bug else obj["original_x2"]  # the reference's wart
        coord_original = [obj["original_x1"], obj["original_y1"], obj["original_x2"], y2]
        for sentence_id, sentence, sentence_attributes in zip(
                bbox_attributes["phrase_IDs"], bbox_attributes["phrases"],
                bbox_attributes["attributes"]):
            for attribute in sentence_attributes:
                _, context, label = attribute.split("|")
                update_objects(objects, bbox=obj["bbox_name"], coord_original=coord_original,
                               sentence_id=sentence_id, sentence=sentence, label=label,
                               context=context)
    return objects


def save_and_get_all_location_condition_pairs(dataset, filename) -> dict:
    """The (condition, context) ↔ location-set index that condition swapping
    draws from, cached in ``filename``."""
    if os.path.exists(filename):
        with open(filename, "rb") as fh:
            return pickle.load(fh)
    pairs = {"location_to_condition": {}, "condition_to_location": {}}
    for i in range(len(dataset)):
        inst = dataset[i]
        for _sid, v in inst["objects"]["sent_to_bboxes"].items():
            sent_cond_to_locs: dict = {}
            for label, context, bbox in zip(v["labels"], v["contexts"], v["bboxes"]):
                sent_cond_to_locs.setdefault((label, context), set()).add(bbox)
            for (label, context), bboxes in sent_cond_to_locs.items():
                key = tuple(sorted(bboxes))
                pairs["condition_to_location"].setdefault((label, context), set()).add(key)
                pairs["location_to_condition"].setdefault(key, set()).add((label, context))
    with open(filename, "wb") as fh:
        pickle.dump(pairs, fh)
    return pairs


class GenerateContextLocationConditionSentences:
    """Template sentences from (condition, context, location) triples,
    a left and a right location of one condition merged into the plural."""

    def __call__(self, conditions, contexts, locations) -> str:
        condition_to_locations: dict = {}
        for context, loc, condition in zip(contexts, locations, conditions):
            condition_to_locations.setdefault(condition, [])
            if context == "yes":
                condition_to_locations[condition].append(loc)
        sentence = ""
        for cond, locs in condition_to_locations.items():
            new_locs = set()
            for loc in locs:
                if ("left" in loc and loc.replace("left", "right") in locs) or \
                   ("right" in loc and loc.replace("right", "left") in locs):
                    new_locs.add(loc.replace("left ", "").replace("right ", "") + "s")
                else:
                    new_locs.add(loc)
            new_locs = list(new_locs)
            if len(locs) == 0:
                sentence += " There is no " + cond + "."
            else:
                if len(new_locs) > 2:
                    loclist = ", ".join(new_locs[:-1]) + ", and " + new_locs[-1]
                else:
                    loclist = " and ".join(new_locs)
                if cond in ("normal", "abnormal"):
                    sentence += " The " + loclist + (" are " if len(locs) > 1 else " is ") + cond + "."
                else:
                    sentence += " There is " + cond + " in the " + loclist + "."
        return sentence.strip()


def swap_left_right_words(sentence: str) -> str:
    """Lower-cases ``sentence`` and swaps every "left" and "right"."""
    return (sentence.lower()
            .replace("right", "right*****")
            .replace("left", "right")
            .replace("right*****", "left"))


# -- row selectors over build_sentences_df's rows ---------------------------

def get_ent_to_bbox(sent_labels, sent_contexts, sent_bbox_names) -> dict:
    out: dict = {}
    for label, context, bbox in zip(sent_labels, sent_contexts, sent_bbox_names):
        out.setdefault((label, context), set()).add(bbox)
    return out


class RowContainsOrDoesNotContainSelector:
    def __init__(self, contains=None, does_not_contain=None, only_contains=False):
        assert contains is not None or does_not_contain is not None
        if only_contains:
            assert does_not_contain is None
        self.contains = set(contains) if contains is not None else None
        self.does_not_contain = set(does_not_contain) if does_not_contain is not None else None
        self.only_contains = only_contains

    def get_row_set(self, row):
        raise NotImplementedError

    def __call__(self, row) -> bool:
        row_set = self.get_row_set(row)
        if self.only_contains:
            return self.contains == row_set
        ok = True
        if self.contains is not None:
            ok = ok and len(self.contains - row_set) == 0
        if self.does_not_contain is not None:
            ok = ok and len(row_set - self.does_not_contain) == len(row_set)
        return ok


class RowLabelAndContextSelector(RowContainsOrDoesNotContainSelector):
    def get_row_set(self, row):
        return set(get_ent_to_bbox(ast.literal_eval(row["sent_labels"]),
                                   ast.literal_eval(row["sent_contexts"]),
                                   ast.literal_eval(row["bbox_names"])).keys())


class RowBBoxSelector(RowContainsOrDoesNotContainSelector):
    def get_row_set(self, row):
        return set(ast.literal_eval(row["bbox_names"]))


class OrSelector:
    def __init__(self, *selectors):
        self.selectors = selectors

    def __call__(self, row) -> bool:
        return any(sel(row) for sel in self.selectors)


# -- the dataset ---------------------------------------------------------------

class ImaGenomeDataset:
    """Grounding dataset over cached MIMIC-CXR images and ImaGenome objects.

    ``records``: a DataFrame of subject_id / study_id / dicom_id rows;
    ``sentences_df`` (for ``group_by='sentence'``): rows with dicom_id and
    sent_id.  An item is flat: the image, the report (the sentence, or the
    study's report), the sentence's boxes in original pixels, an id, the
    objects index, the sentence id and the item's index.  Every random draw
    (randomization, condition swap, random report, masking) comes from
    ``rng``, shared by all items."""

    def __init__(self, records, mimic_cxr_filer: MimicCxrFiler, imagenome_filer: ImaGenomeFiler,
                 group_by: str = "sentence", gold: bool = False,
                 randomize_reports: bool = False, randomize_objects_mode: str | None = None,
                 sentences_df=None, sentence_selector=None,
                 swap_left_right: bool = False, generate_sent: bool = False,
                 swap_conditions: bool = False, valid_locations_conditions=None,
                 text_masker=None, prob_of_masking: float = 0.5,
                 num_rand_sent: int | None = None, rng: random.Random | None = None,
                 fix_coord_bug: bool = False):
        self.records = records.reset_index(drop=True)
        self.filer = mimic_cxr_filer
        self.imagenome = imagenome_filer
        self.group_by_sentence = group_by == "sentence"
        self.group_by = group_by
        self.gold = gold
        self.gold_objects_df = imagenome_filer.get_gold_file(GOLD_OBJECTS_FILE) if gold else None
        self.randomize_objects_mode = randomize_objects_mode
        self.sentences_df = sentences_df
        if self.group_by_sentence:
            assert sentences_df is not None
            if sentence_selector is not None:
                self.sentences_df = self.sentences_df[self.sentences_df.apply(sentence_selector, axis=1)]
            if num_rand_sent is not None:
                self.sentences_df = self.sentences_df.sample(num_rand_sent, random_state=0)
            self.sentences_df = self.sentences_df.reset_index(drop=True)
        self.swap_left_right = swap_left_right
        self.generate_sent = generate_sent
        self.sentence_generator = GenerateContextLocationConditionSentences() if generate_sent else None
        self.swap_conditions = swap_conditions
        self.valid_locations_conditions = valid_locations_conditions
        if swap_conditions:
            assert generate_sent and valid_locations_conditions is not None
        self.randomize_reports = randomize_reports
        self.text_masker = text_masker
        self.prob_of_masking = prob_of_masking
        self.rng = rng or random.Random(0)
        self.fix_coord_bug = fix_coord_bug

    def __len__(self) -> int:
        if self.group_by_sentence:
            return len(self.sentences_df)
        if self.group_by == "image":
            return len(self.records)
        return self.records[{"study": "study_id", "patient": "subject_id"}[self.group_by]].nunique()

    def _objects_for(self, dicom_id) -> dict:
        if self.imagenome.has_objects(dicom_id):
            objects = self.imagenome.get_objects(dicom_id)
        else:
            objects = get_objects(dicom_id, self.gold, self.gold_objects_df,
                                  self.imagenome, fix_coord_bug=self.fix_coord_bug)
            try:
                self.imagenome.save_objects(objects, dicom_id)
            except OSError:  # a read-only mirror: the cache is optional
                pass
        if self.randomize_objects_mode is not None:
            objects = self.randomize_objects(objects, dicom_id, self.randomize_objects_mode)
        return objects

    # -- object randomization ----------------------------------------------
    def get_negative_parts_for_objects(self, objects, get_external_negatives: bool,
                                       part_type: str, dicom_id=None) -> list[dict]:
        assert part_type in ("sentence", "bbox")
        neg_parts: list[dict] = []
        while len(neg_parts) < len(objects["sent_to_bboxes"]):
            if get_external_negatives:
                other = self.records[self.records.dicom_id != dicom_id]
                neg_row = other.iloc[self.rng.randrange(len(other))]
                neg_objects = get_objects(neg_row.dicom_id, self.gold, self.gold_objects_df,
                                          self.imagenome, fix_coord_bug=self.fix_coord_bug)
                if not neg_objects["sent_to_bboxes"]:
                    continue
            else:
                neg_objects = objects
            for sentence_id, obj in neg_objects["sent_to_bboxes"].items():
                part = ({k: v for k, v in obj.items() if k != "sentence"}
                        if part_type == "bbox" else {"sentence": obj["sentence"]})
                part["original_sentence_id"] = sentence_id
                part["part_randomized"] = part_type
                neg_parts.append(part)
        neg_parts = neg_parts[: len(objects["sent_to_bboxes"])]
        self.rng.shuffle(neg_parts)
        return neg_parts

    def randomize_objects(self, objects, dicom_id=None, mode: str = "random_sentences") -> dict:
        assert mode in ("random_bboxes", "random_sentences", "shuffle_bboxes_sentences", "shuffle")
        if mode == "shuffle":
            mode = "shuffle_bboxes_sentences"
        part_type = "sentence" if mode == "random_sentences" else "bbox"
        external = mode != "shuffle_bboxes_sentences"
        neg_parts = self.get_negative_parts_for_objects(objects, external, part_type, dicom_id)
        new_objects = {"bbox_to_sents": {}, "sent_to_bboxes": {}, "mode": mode}
        for (sentence_id, original), neg in zip(objects["sent_to_bboxes"].items(), neg_parts):
            new_value = dict(original)
            new_value.update(neg)
            for bbox, coord, label, context in zip(
                    new_value["bboxes"], new_value["coords_original"],
                    new_value["labels"], new_value["contexts"]):
                update_objects(new_objects, bbox, coord, sentence_id, new_value["sentence"],
                               label, context)
            new_objects["sent_to_bboxes"][sentence_id].update(new_value)
        return new_objects

    # -- item assembly -------------------------------------------------------
    def __getitem__(self, item: int) -> dict:
        if self.group_by_sentence:
            row = self.sentences_df.iloc[item]
            sent_id, dicom_id = row.sent_id, row.dicom_id
            rec = self.records[self.records.dicom_id == dicom_id].iloc[0]
        else:
            sent_id = None
            rec = self.records.iloc[item]
            dicom_id = rec.dicom_id

        image = self.filer.get_image(dicom_id)
        objects = self._objects_for(dicom_id)

        if sent_id is not None:
            sent_info = objects["sent_to_bboxes"][sent_id]
            if self.generate_sent:
                labels, contexts, bboxes = sent_info["labels"], sent_info["contexts"], sent_info["bboxes"]
                if self.swap_conditions:
                    labels, contexts, bboxes = self.get_swapped_conditions(labels, contexts, bboxes)
                text = self.sentence_generator(labels, contexts, bboxes)
            else:
                text = sent_info["sentence"]
                if self.swap_left_right:
                    text = swap_left_right_words(text)
            bboxes_coords = sent_info["coords_original"]
        else:
            text = self.filer.get_report(rec.subject_id, rec.study_id)
            if self.randomize_reports:
                neg = self.records.iloc[self.rng.randrange(len(self.records))]
                text = self.filer.get_report(neg.subject_id, neg.study_id)
            bboxes_coords = []

        if self.text_masker is not None and (
                self.prob_of_masking == 1 or self.rng.random() < self.prob_of_masking):
            text = self.text_masker(text)

        return {
            "image": image,
            "report": text,
            "bboxes": bboxes_coords,
            "id": f"dicom_{dicom_id}_sent_{sent_id}" if sent_id is not None else str(dicom_id),
            "objects": objects,
            "sent_id": sent_id,
            "index": item,
        }

    def get_swapped_conditions(self, labels, contexts, bboxes):
        """Each (condition, context) of the sentence replaced by another one
        seen at the same set of locations, where there is one."""
        condition_to_locations: dict = {}
        for label, context, bbox in zip(labels, contexts, bboxes):
            condition_to_locations.setdefault((label, context), set()).add(bbox)
        new_labels, new_contexts, new_bboxes = [], [], []
        for (label, context), bbox_set in condition_to_locations.items():
            key = tuple(sorted(bbox_set))
            potential = self.valid_locations_conditions["location_to_condition"].get(key, set())
            potential = list(potential.difference(condition_to_locations.keys()))
            if potential:
                self.rng.shuffle(potential)
                label, context = potential[0]
            for bbox in key:
                new_labels.append(label)
                new_contexts.append(context)
                new_bboxes.append(bbox)
        return new_labels, new_contexts, new_bboxes


def build_sentences_df(records, imagenome_filer: ImaGenomeFiler, gold: bool = False,
                       gold_objects_df=None, fix_coord_bug: bool = False):
    """One row per (dicom, sentence): ids, the sentence, and its box names,
    labels, contexts and boxes (as ``repr`` strings)."""
    import pandas as pd

    rows = []
    for rec in records.itertuples(index=False):
        objects = get_objects(rec.dicom_id, gold, gold_objects_df, imagenome_filer,
                              fix_coord_bug=fix_coord_bug)
        for sent_id, info in objects["sent_to_bboxes"].items():
            rows.append({
                "dicom_id": rec.dicom_id,
                "subject_id": rec.subject_id,
                "study_id": rec.study_id,
                "sent_id": sent_id,
                "sentence": info["sentence"],
                "bbox_names": repr(info["bboxes"]),
                "sent_labels": repr(info["labels"]),
                "sent_contexts": repr(info["contexts"]),
                "bboxes": repr(info["coords_original"]),
            })
    return pd.DataFrame(rows)


class ImaGenomeDataModule(_PretrainModule):
    """``data.dataset: imagenome``: the splits of ``silver_dataset/splits``
    (the test split is the gold set, ``images_to_avoid.csv`` with the gold
    table's boxes, when ``data.gold_test``), one :class:`ImaGenomeDataset`
    per split with ``data``'s perturbations, seeded by ``random_seed``.
    ``records`` and ``sentences`` (dicts by split, or one frame for all
    splits) stand in for the mirror's tables."""

    def __init__(self, cfg: Config, mimic_cxr_filer: MimicCxrFiler | None = None,
                 imagenome_filer: ImaGenomeFiler | None = None,
                 records=None, sentences: dict | None = None, device=None):
        data = cfg.data or Config()
        self.filer = mimic_cxr_filer or MimicCxrFiler(data.mimic_cxr_download_directory)
        self.imagenome = imagenome_filer or ImaGenomeFiler(data.imagenome_download_directory)
        self._records = records
        self._sentences = sentences or {}
        super().__init__(cfg, device=device)

    def records(self, split: str):
        if self._records is not None:
            return self._records[split] if isinstance(self._records, dict) else self._records
        return self.imagenome.get_split(split if split != "test" or not self.cfg.data.gold_test
                                        else "gold")

    def _gold_df(self, gold: bool):
        return self.imagenome.get_gold_file(GOLD_OBJECTS_FILE) if gold else None

    def dataset(self, split: str) -> ImaGenomeDataset:
        data = self.cfg.data or Config()
        gold = bool(data.gold_test) and split == "test"
        records = self.records(split)
        sentences_df = self._sentences.get(split)
        if sentences_df is None and (data.group_by or "sentence") == "sentence":
            sentences_df = build_sentences_df(records, self.imagenome, gold, self._gold_df(gold))
        masker = None
        if data.mask_mode:
            masker = build_masker(data.mask_mode, mask_prob=float(data.mask_prob or 0.15))
        return ImaGenomeDataset(
            records, self.filer, self.imagenome,
            group_by=data.group_by or "sentence",
            gold=gold,
            randomize_reports=bool(data.randomize_reports),
            randomize_objects_mode=data.randomize_objects_mode,
            sentences_df=sentences_df,
            swap_left_right=bool(data.swap_left_right),
            generate_sent=bool(data.generate_sent),
            swap_conditions=bool(data.swap_conditions),
            valid_locations_conditions=None if not data.swap_conditions else
            save_and_get_all_location_condition_pairs(
                self.dataset_without_perturbations(split),
                self.imagenome.get_full_path("location_condition_pairs.pkl")),
            text_masker=masker,
            prob_of_masking=float(data.prob_of_masking or 0.5),
            rng=random.Random(int(self.cfg.random_seed or 0)),
        )

    def dataset_without_perturbations(self, split: str) -> ImaGenomeDataset:
        records = self.records(split)
        gold = bool(self.cfg.data.gold_test) and split == "test"
        return ImaGenomeDataset(
            records, self.filer, self.imagenome, group_by="sentence", gold=gold,
            sentences_df=build_sentences_df(records, self.imagenome, gold, self._gold_df(gold)),
        )

    def get_dataset(self, split: str) -> ImaGenomeDataset:  # the reference's name
        return self.dataset(split)
