"""Dataset paths, CSV columns and the zero-shot prompt grammar (the port's
own copy of ``gloria_tpu.constants``).

The dataset paths come from the environment (``GLORIA_DATA_ROOT``,
``CHEXPERT_DATA_DIR``, ``SIIM_DATA_DIR``, ``RSNA_DATA_DIR``), read once at
import, as in the JAX package.

``CHEXPERT_CLASS_PROMPTS`` is the zero-shot prompt grammar: per class, a
severity x subtype x location product.  The strings match the reference
exactly, typos included ("apperance of", "presistent", "uppper"), so both
packages sample the same prompt sets.
"""

import os
from pathlib import Path

DATA_ROOT = Path(os.environ.get("GLORIA_DATA_ROOT", "./data"))

CHEXPERT_DATA_DIR = Path(os.environ.get("CHEXPERT_DATA_DIR", DATA_ROOT / "CheXpert-v1.0"))
CHEXPERT_TRAIN_CSV = CHEXPERT_DATA_DIR / "train_split.csv"
CHEXPERT_VALID_CSV = CHEXPERT_DATA_DIR / "valid_split.csv"
# the hidden-label test set means the public valid.csv doubles as test
CHEXPERT_TEST_CSV = CHEXPERT_DATA_DIR / "valid.csv"

CHEXPERT_VIEW_COL = "Frontal/Lateral"
CHEXPERT_PATH_COL = "Path"
CHEXPERT_REPORT_COL = "Report Impression"

# the five competition tasks the classification phase predicts
CHEXPERT_COMPETITION_TASKS = [
    "Atelectasis",
    "Cardiomegaly",
    "Consolidation",
    "Edema",
    "Pleural Effusion",
]

# the U-ones / U-zeros policy of the CheXpert paper: an uncertain label (-1)
# becomes this value (1 = uncertain counted as positive)
CHEXPERT_UNCERTAIN_MAPPINGS = {
    "Atelectasis": 1,
    "Cardiomegaly": 0,
    "Consolidation": 0,
    "Edema": 1,
    "Pleural Effusion": 1,
}

# SIIM pneumothorax segmentation
PNEUMOTHORAX_DATA_DIR = Path(os.environ.get("SIIM_DATA_DIR", DATA_ROOT / "siim"))
PNEUMOTHORAX_ORIGINAL_TRAIN_CSV = PNEUMOTHORAX_DATA_DIR / "train-rle.csv"
PNEUMOTHORAX_TRAIN_CSV = PNEUMOTHORAX_DATA_DIR / "train.csv"
PNEUMOTHORAX_VALID_CSV = PNEUMOTHORAX_DATA_DIR / "valid.csv"
PNEUMOTHORAX_TEST_CSV = PNEUMOTHORAX_DATA_DIR / "test.csv"
PNEUMOTHORAX_IMG_DIR = PNEUMOTHORAX_DATA_DIR / "dicom-images-train"
PNEUMOTHORAX_IMG_SIZE = 1024

# RSNA pneumonia classification
PNEUMONIA_DATA_DIR = Path(os.environ.get("RSNA_DATA_DIR", DATA_ROOT / "rsna_pneumonia"))
PNEUMONIA_ORIGINAL_TRAIN_CSV = PNEUMONIA_DATA_DIR / "stage_2_train_labels.csv"
PNEUMONIA_TRAIN_CSV = PNEUMONIA_DATA_DIR / "train.csv"
PNEUMONIA_VALID_CSV = PNEUMONIA_DATA_DIR / "val.csv"
PNEUMONIA_TEST_CSV = PNEUMONIA_DATA_DIR / "test.csv"
PNEUMONIA_IMG_DIR = PNEUMONIA_DATA_DIR / "stage_2_train_images"

CHEXPERT_CLASS_PROMPTS = {
    "Atelectasis": {
        "severity": ["", "mild", "minimal"],
        "subtype": [
            "subsegmental atelectasis",
            "linear atelectasis",
            "trace atelectasis",
            "bibasilar atelectasis",
            "retrocardiac atelectasis",
            "bandlike atelectasis",
            "residual atelectasis",
        ],
        "location": [
            "at the mid lung zone",
            "at the upper lung zone",
            "at the right lung zone",
            "at the left lung zone",
            "at the lung bases",
            "at the right lung base",
            "at the left lung base",
            "at the bilateral lung bases",
            "at the left lower lobe",
            "at the right lower lobe",
        ],
    },
    "Cardiomegaly": {
        "severity": [""],
        "subtype": [
            "cardiac silhouette size is upper limits of normal",
            "cardiomegaly which is unchanged",
            "mildly prominent cardiac silhouette",
            "portable view of the chest demonstrates stable cardiomegaly",
            "portable view of the chest demonstrates mild cardiomegaly",
            "persistent severe cardiomegaly",
            "heart size is borderline enlarged",
            "cardiomegaly unchanged",
            "heart size is at the upper limits of normal",
            "redemonstration of cardiomegaly",
            "ap erect chest radiograph demonstrates the heart size is the upper limits of normal",
            "cardiac silhouette size is mildly enlarged",
            "mildly enlarged cardiac silhouette, likely left ventricular enlargement. other chambers are less prominent",
            "heart size remains at mildly enlarged",
            "persistent cardiomegaly with prominent upper lobe vessels",
        ],
        "location": [""],
    },
    "Consolidation": {
        "severity": ["", "increased", "improved", "apperance of"],
        "subtype": [
            "bilateral consolidation",
            "reticular consolidation",
            "retrocardiac consolidation",
            "patchy consolidation",
            "airspace consolidation",
            "partial consolidation",
        ],
        "location": [
            "at the lower lung zone",
            "at the upper lung zone",
            "at the left lower lobe",
            "at the right lower lobe",
            "at the left upper lobe",
            "at the right uppper lobe",
            "at the right lung base",
            "at the left lung base",
        ],
    },
    "Edema": {
        "severity": [
            "",
            "mild",
            "improvement in",
            "presistent",
            "moderate",
            "decreased",
        ],
        "subtype": [
            "pulmonary edema",
            "trace interstitial edema",
            "pulmonary interstitial edema",
        ],
        "location": [""],
    },
    "Pleural Effusion": {
        "severity": ["", "small", "stable", "large", "decreased", "increased"],
        "location": ["left", "right", "tiny"],
        "subtype": [
            "bilateral pleural effusion",
            "subpulmonic pleural effusion",
            "bilateral pleural effusion",
        ],
    },
}
