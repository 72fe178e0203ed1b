"""Offline split preparation for the downstream datasets.

The port's own copy of ``gloria_tpu.data.preprocess``'s RSNA pneumonia and
SIIM pneumothorax parts: each reads the dataset's original label CSV and
writes train / valid / test CSVs split 70 / 15 / 15 with the reference's
seeds.  The split is sklearn's ``train_test_split(random_state=0)``
computed here (:func:`train_test_split`), so the port needs no sklearn and
writes the same CSVs.  The CheXpert 5×200 benchmark and split come with
the zero-shot evaluation (ROADMAP.md A3).

    python -m gloria_tpu_torch.data.preprocess -d pneumonia|pneumothorax
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np

from .. import constants


def train_test_split(df, test_size: float, random_state: int = 0):
    """sklearn's ``train_test_split(df, test_size=..., random_state=...)``
    for a DataFrame: ``ceil(test_size · n)`` rows to test, both parts in the
    order of one ``RandomState(random_state).permutation(n)``."""
    n = len(df)
    n_test = math.ceil(test_size * n)
    perm = np.random.RandomState(random_state).permutation(n)
    return df.iloc[perm[n_test:]], df.iloc[perm[:n_test]]


def _write_splits(df, label: str, paths: tuple, test_fac: float) -> None:
    train_df, test_val_df = train_test_split(df, test_size=test_fac * 2, random_state=0)
    test_df, valid_df = train_test_split(test_val_df, test_size=0.5, random_state=0)
    for name, d in [("train", train_df), ("valid", valid_df), ("test", test_df)]:
        print(f"Number of {name} samples: {len(d)}")
        print(d[label].value_counts())
    for d, path in zip((train_df, valid_df, test_df), paths):
        d.to_csv(path)


def preprocess_pneumonia_data(test_fac: float = 0.15) -> None:
    import pandas as pd

    try:
        df = pd.read_csv(constants.PNEUMONIA_ORIGINAL_TRAIN_CSV)
    except Exception as exc:
        raise RuntimeError("Please make sure the RSNA Pneumonia dataset is stored at "
                           f"{constants.PNEUMONIA_DATA_DIR}") from exc

    def create_bbox(row):
        if row["Target"] == 0:
            return 0
        return [row["x"], row["y"], row["x"] + row["width"], row["y"] + row["height"]]

    df["bbox"] = df.apply(create_bbox, axis=1)
    df = df[["patientId", "bbox"]].groupby("patientId").agg(list).reset_index()
    df["bbox"] = df["bbox"].apply(lambda x: None if x == [0] else x)
    df["Target"] = df["bbox"].apply(lambda x: 0 if x is None else 1)
    df["Path"] = df["patientId"].apply(lambda x: constants.PNEUMONIA_IMG_DIR / (x + ".dcm"))
    _write_splits(df, "Target", (constants.PNEUMONIA_TRAIN_CSV, constants.PNEUMONIA_VALID_CSV,
                                 constants.PNEUMONIA_TEST_CSV), test_fac)


def preprocess_pneumothorax_data(test_fac: float = 0.15) -> None:
    import pandas as pd

    try:
        df = pd.read_csv(constants.PNEUMOTHORAX_ORIGINAL_TRAIN_CSV)
    except Exception as exc:
        raise RuntimeError("Please make sure the SIIM Pneumothorax dataset is stored at "
                           f"{constants.PNEUMOTHORAX_DATA_DIR}") from exc

    img_paths: dict[str, str] = {}
    for subdir, _dirs, files in os.walk(constants.PNEUMOTHORAX_IMG_DIR):
        for f in files:
            if "dcm" in f:
                img_paths[f[:-4]] = os.path.join(subdir, f)

    df["Label"] = df.apply(lambda x: 0.0 if x[" EncodedPixels"] == " -1" else 1.0, axis=1)
    df["Path"] = df["ImageId"].apply(lambda x: img_paths[x])
    _write_splits(df, "Label", (constants.PNEUMOTHORAX_TRAIN_CSV,
                                constants.PNEUMOTHORAX_VALID_CSV,
                                constants.PNEUMOTHORAX_TEST_CSV), test_fac)


_DATASETS = {
    "pneumonia": preprocess_pneumonia_data,
    "pneumothorax": preprocess_pneumothorax_data,
}


def available_datasets() -> list[str]:
    return list(_DATASETS.keys())


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("-d", "--dataset", required=True,
                        help=f"one of {available_datasets()}")
    args = parser.parse_args()
    name = args.dataset.lower()
    if name not in _DATASETS:
        raise RuntimeError(f"Dataset {args.dataset} not found; available = {available_datasets()}")
    _DATASETS[name]()
