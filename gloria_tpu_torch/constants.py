"""Dataset paths, CSV columns and the zero-shot prompt grammar (the port's
own copy of ``gloria_tpu.constants``).

The CheXpert paths come from the environment (``GLORIA_DATA_ROOT``,
``CHEXPERT_DATA_DIR``), read once at import, as in the JAX package.

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
