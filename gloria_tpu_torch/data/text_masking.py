"""Text masking for the masked-text ablations.

The port's own copy of ``gloria_tpu.data.text_masking`` (the reference's
``gloria/datasets/text_masking.py``): word, sentence, entity and
clinical-entity maskers and mask-everything, chosen by
``data.mask_mode`` through :func:`build_masker`.

spaCy and scispaCy are optional: the sentence and entity maskers use spaCy
when it imports (inside the maskers, never at module import) and otherwise
split sentences with a regex and find entities in a clinical-term lexicon,
so every mode runs without them, as in JAX.
"""

from __future__ import annotations

import random
import re


class MaskAll:
    def __init__(self, mask_token: str):
        self.mask_token = mask_token

    def __call__(self, text: str) -> str:
        return self.mask_token


class TextMasker:
    def __init__(self, mask_token: str, mask_prob: float = 0.15, rng: random.Random | None = None):
        self.mask_token = mask_token
        self.mask_prob = mask_prob
        self.rng = rng or random


def _num_masks(n: int, prob: float) -> int:
    # reference convention: at least 1, at most n-1 (never mask everything)
    return min(max(int(n * prob), 1), max(n - 1, 0))


def mask_words(text: str, mask_token: str, mask_prob: float = 0.15, rng=random) -> str:
    words = text.split()
    num = _num_masks(len(words), mask_prob)
    indices = list(range(len(words)))
    rng.shuffle(indices)
    for i in indices[:num]:
        words[i] = mask_token
    return " ".join(words)


def _mask_spans(text: str, spans: list[tuple[int, int]], mask_token: str,
                mask_prob: float, rng) -> str:
    num = _num_masks(len(spans), mask_prob)
    indices = list(range(len(spans)))
    rng.shuffle(indices)
    chosen = sorted((spans[i] for i in indices[:num]), key=lambda s: s[0])
    segments, offset = [], 0
    for start, end in chosen:
        segments.append(text[offset:start])
        segments.append(mask_token)
        offset = end
    segments.append(text[offset:])
    return "".join(segments)


_SENT_BOUNDARY = re.compile(r"[^.!?]+[.!?]?")

# Curated radiology findings/anatomy lexicon for the clinical-entity
# fallback (the reference links via scispaCy+UMLS, text_masking.py:50-58 —
# an optional dependency).  Sources: the CheXpert label set and prompt-grammar
# subtype phrases (constants.py), the ImaGenome attribute ontology
# (anatomicalfinding / disease / technicalassessment / tubesandlines
# conditions, encoded in ``_IMAGENOME_CONDITIONS`` below), and the common
# RadGraph observation/anatomy vocabulary.  Multi-word phrases first so the
# alternation is longest-match.
#
# Measured recall (on the JAX copy of this lexicon,
# tests/test_mimic.py::test_clinical_lexicon_realistic_recall):
# 100% of template sentences generated from the full ImaGenome condition
# vocabulary x location grammar contain >=1 recognized entity span, and
# >=95% of a realistic MIMIC-style report-prose corpus; the scispaCy UMLS
# path (when installable) additionally links abbreviations and rare
# out-of-lexicon terms, which is the remaining fidelity gap.
_CLINICAL_PHRASES = [
    # multi-word findings (longest first)
    "loculated pleural effusion", "trace interstitial edema",
    "bilateral pleural effusion", "subpulmonic pleural effusion",
    "acute respiratory distress syndrome", "chronic obstructive pulmonary disease",
    "diffuse alveolar damage", "pulmonary vascular congestion",
    "pleural effusion", "pericardial effusion", "lung opacity", "airspace opacity",
    "airspace disease", "pulmonary edema", "interstitial edema", "alveolar edema",
    "septal thickening", "pleural thickening", "interstitial markings",
    "vascular congestion", "hilar congestion", "mediastinal widening",
    "enlarged cardiac silhouette", "cardiac silhouette", "costophrenic angle",
    "subcutaneous emphysema", "rib fracture", "clavicle fracture",
    "compression fracture", "bony lesion", "lytic lesion", "lung cancer",
    "lung lesion", "lung nodule", "pulmonary nodule", "miliary nodules",
    "ground glass opacity", "ground-glass opacity", "tree-in-bud",
    "air bronchogram", "aspiration pneumonia", "bacterial pneumonia",
    "hiatal hernia", "tension pneumothorax", "apical pneumothorax",
    "basilar atelectasis", "plate-like atelectasis", "platelike atelectasis",
    "lobar collapse", "volume loss", "pleural fluid", "free air",
    "support devices", "endotracheal tube", "chest tube", "central line",
    "picc line", "pacemaker", "sternotomy wires",
    # single-word findings
    "atelectasis", "cardiomegaly", "consolidation", "edema", "effusion",
    "pneumothorax", "pneumonia", "opacity", "opacities", "fracture",
    "lesion", "infiltrate", "infiltrates", "infiltration", "emphysema",
    "fibrosis", "nodule", "nodules", "nodularity", "mass", "masses",
    "granuloma", "granulomas", "calcification", "calcifications",
    "scarring", "bronchiectasis", "hyperinflation", "hernia",
    "congestion", "hemorrhage", "hematoma", "abscess", "cavitation",
    "empyema", "tuberculosis", "sarcoidosis", "malignancy", "carcinoma",
    "metastasis", "metastases", "lymphadenopathy", "aeration", "collapse",
    "kyphosis", "scoliosis", "osteopenia", "osteoporosis",
    # anatomy commonly masked as entity spans
    "costophrenic", "retrocardiac", "perihilar", "hilar", "apical",
    "diaphragm", "hemidiaphragm", "mediastinum", "mediastinal", "pleura",
    "pleural", "trachea", "carina", "aorta", "aortic", "cardiac", "heart",
    "lung", "lungs", "lobe", "lingula", "bronchus", "bronchi", "clavicle",
    "ribs", "spine", "vertebral", "hilum",
]

# The Chest ImaGenome attribute ontology's condition names (the `label`
# field of scene-graph ``attributes`` entries, category|context|label —
# ``data/mimic.py:get_objects``).  Template sentence generation
# (``GenerateContextLocationConditionSentences``) and condition swapping
# insert these verbatim, so the lexicon must recognize each one.
_IMAGENOME_CONDITIONS = [
    # anatomicalfinding
    "lung opacity", "airspace opacity", "consolidation", "infiltration",
    "atelectasis", "linear/patchy atelectasis", "lobar/segmental collapse",
    "pulmonary edema/hazy opacity", "vascular congestion",
    "vascular redistribution", "increased reticular markings/ild pattern",
    "pleural effusion", "costophrenic angle blunting",
    "pleural/parenchymal scarring", "enlarged cardiac silhouette",
    "mediastinal displacement", "mediastinal widening", "enlarged hilum",
    "tortuous aorta", "vascular calcification", "pneumomediastinum",
    "pneumothorax", "hydropneumothorax", "lung lesion",
    "mass/nodule (not otherwise specified)", "multiple masses/nodules",
    "calcified nodule", "superior mediastinal mass/enlargement",
    "rib fracture", "clavicle fracture", "spinal fracture", "hyperaeration",
    "cyst/bullae", "elevated hemidiaphragm", "diaphragmatic eversion",
    "sub-diaphragmatic air", "subcutaneous air", "hernia", "scoliosis",
    "spinal degenerative changes", "shoulder osteoarthritis", "bone lesion",
    # disease
    "pneumonia", "fluid overload/heart failure", "copd/emphysema",
    "granulomatous disease", "interstitial lung disease", "goiter",
    "lung cancer", "aspiration", "alveolar hemorrhage",
    "pericardial effusion",
    # nlp
    "abnormal", "normal",
    # technicalassessment
    "low lung volumes", "rotated", "artifact", "breast/nipple shadows",
    "skin fold",
    # tubesandlines
    "chest tube", "mediastinal drain", "pigtail catheter",
    "endotracheal tube", "tracheostomy tube", "picc", "ij line",
    "chest port", "cardiac pacer and wires", "subclavian line",
    "swan-ganz catheter", "intra-aortic balloon pump", "enteric tube",
]
# Terms the base lexicon doesn't already cover (slash-compounds are matched
# whole; their components are also listed so free prose hits them)
_CLINICAL_PHRASES += [c for c in _IMAGENOME_CONDITIONS if c not in _CLINICAL_PHRASES]
_CLINICAL_PHRASES += [
    "vascular redistribution", "reticular markings", "ild pattern",
    "interstitial lung disease", "mediastinal displacement", "enlarged hilum",
    "tortuous aorta", "vascular calcification", "pneumomediastinum",
    "hydropneumothorax", "calcified nodule", "spinal fracture",
    "hyperaeration", "cyst", "bullae", "bulla", "blebs",
    "diaphragmatic eversion", "sub-diaphragmatic air", "subdiaphragmatic air",
    "subcutaneous air", "degenerative changes", "osteoarthritis",
    "fluid overload", "heart failure", "copd", "granulomatous disease",
    "goiter", "aspiration", "low lung volumes", "skin fold", "artifact",
    "nipple shadows", "breast shadows", "cardiomediastinal silhouette",
    "cardiomediastinal", "tracheostomy tube", "pigtail catheter",
    "mediastinal drain", "swan-ganz catheter", "intra-aortic balloon pump",
    "subclavian line", "ij line", "chest port", "enteric tube",
    "nasogastric tube", "cardiac pacer", "pacer wires", "hazy opacity",
]
_CLINICAL_PHRASES = list(dict.fromkeys(_CLINICAL_PHRASES))
_CLINICAL_PHRASES.sort(key=len, reverse=True)  # longest-match alternation
# (?<!\w)/(?!\w) instead of \b: phrases that END in a non-word char —
# "mass/nodule (not otherwise specified)" — can never satisfy a trailing \b
# before a space (non-word/non-word is not a boundary), so \b silently
# dropped them to their fragments
_CLINICAL_RE = re.compile(
    r"(?<!\w)(?:" + "|".join(re.escape(p).replace(r"\ ", r"\s+") for p in _CLINICAL_PHRASES) + r")(?!\w)",
    re.IGNORECASE,
)


def _spacy_nlp(model: str = "en_core_web_sm"):
    try:
        import spacy

        return spacy.load(model)
    except Exception:
        return None


def mask_sentences(text: str, mask_token: str, nlp=None, mask_prob: float = 0.15, rng=random) -> str:
    if nlp is not None:
        spans = [(s.start_char, s.end_char) for s in nlp(text).sents]
    else:
        spans = [(m.start(), m.end()) for m in _SENT_BOUNDARY.finditer(text) if m.group().strip()]
    if not spans:
        return text
    return _mask_spans(text, spans, mask_token, mask_prob, rng)


def mask_entities(text: str, mask_token: str, nlp=None, mask_prob: float = 0.15,
                  trim_entities_func=None, rng=random) -> str:
    if nlp is not None:
        ents = list(nlp(text).ents)
        if trim_entities_func is not None:
            ents = trim_entities_func(ents)
        spans = [(e.start_char, e.end_char) for e in ents]
    else:
        spans = [(m.start(), m.end()) for m in _CLINICAL_RE.finditer(text)]
    if not spans:
        return text
    return _mask_spans(text, spans, mask_token, mask_prob, rng)


class WordMasker(TextMasker):
    def __call__(self, text: str) -> str:
        return mask_words(text, self.mask_token, self.mask_prob, self.rng)


class SentenceMasker(TextMasker):
    def __init__(self, mask_token: str, mask_prob: float = 0.5, nlp=None, rng=None):
        super().__init__(mask_token, mask_prob, rng)
        self.nlp = nlp if nlp is not None else _spacy_nlp()

    def __call__(self, text: str) -> str:
        return mask_sentences(text, self.mask_token, self.nlp, self.mask_prob, self.rng)


class EntityMasker(TextMasker):
    def __init__(self, mask_token: str, mask_prob: float = 0.5, nlp=None,
                 trim_entities_func=None, rng=None):
        super().__init__(mask_token, mask_prob, rng)
        self.nlp = nlp if nlp is not None else _spacy_nlp()
        self.trim_entities_func = trim_entities_func

    def __call__(self, text: str) -> str:
        return mask_entities(text, self.mask_token, self.nlp, self.mask_prob,
                             self.trim_entities_func, self.rng)


class ClinicalEntityMasker(EntityMasker):
    """UMLS clinical-entity masking (reference uses scispaCy + abbreviation
    detector + UMLS linker, text_masking.py:50-58); falls back to the
    clinical-findings lexicon when scispaCy is absent."""

    def __init__(self, mask_token: str, mask_prob: float = 0.5, rng=None):
        nlp = None
        try:
            import spacy

            nlp = spacy.load("en_core_sci_sm")
            nlp.add_pipe("abbreviation_detector")
            nlp.add_pipe("scispacy_linker",
                         config={"resolve_abbreviations": True, "linker_name": "umls"})
        except Exception:
            nlp = None
        super().__init__(mask_token, mask_prob, nlp=nlp,
                         trim_entities_func=lambda e: e, rng=rng)


def build_masker(mask_mode: str, mask_token: str = "[MASK]", mask_prob: float = 0.15,
                 rng=None) -> TextMasker:
    """cfg.data.mask_mode → masker (reference mimic_data.py:1237-1245)."""
    table = {
        "word": WordMasker,
        "sentence": SentenceMasker,
        "entity": EntityMasker,
        "clinical_entity": ClinicalEntityMasker,
        "all": MaskAll,
    }
    if mask_mode == "all":
        return MaskAll(mask_token)
    return table[mask_mode](mask_token, mask_prob, rng=rng)
