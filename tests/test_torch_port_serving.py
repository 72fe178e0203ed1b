"""The serving slice end to end: the port (on the CPU) against the JAX package.

The fixture mirrors ``tests/test_serving.py``: the same tiny config, the
same tokenizer corpus, the same classes; the port gets the JAX weights
through ``state_dict_from_jax``.  Scores agree to 1e-3: both sides are f32,
but the image tower's convolutions are summed in another order by XLA and
oneDNN, and the local score passes those differences through two softmaxes
and exp(5·cos).  Within one package, rows that differ only by their batch
agree to 2e-4, as in ``tests/test_serving.py``.
"""

import base64
import io
import json
import random
import urllib.error
import urllib.request
from concurrent.futures import wait

import numpy as np
import pytest
import torch

import jax

from gloria_tpu import api as japi
from gloria_tpu.configs import Config
from gloria_tpu.data.pretraining_dataset import SyntheticPretrainingDataset
from gloria_tpu.data.tokenizer import WordPieceTokenizer as JWordPieceTokenizer
from gloria_tpu.models import GLoRIA
from gloria_tpu.serving import InferenceEngine as JInferenceEngine
from gloria_tpu.utils.torch_export import save_reference_checkpoint
from gloria_tpu_torch import api as tapi
from gloria_tpu_torch.configs import Config as TConfig
from gloria_tpu_torch.data.tokenizer import WordPieceTokenizer
from gloria_tpu_torch.ops import local_sim
from gloria_tpu_torch.serving import DynamicBatcher, InferenceEngine, _next_bucket, serve_http
from gloria_tpu_torch.utils.weights import state_dict_from_jax

SCORE_TOL = 1e-3
SAME_PACKAGE_TOL = 2e-4

CFG = {
    "model": {
        "gloria": {"temp1": 4.0, "temp2": 5.0, "temp3": 10.0,
                   "local_loss_weight": 1.0, "global_loss_weight": 1.0},
        "vision": {"model_name": "resnet_18"},
        "text": {"embedding_dim": 32, "last_n_layers": 4, "agg_tokens": True,
                 "aggregate_method": "sum",
                 "bert_config": {"vocab_size": 256, "hidden_size": 32, "num_layers": 2,
                                 "num_heads": 4, "intermediate_size": 64,
                                 "max_position_embeddings": 48}},
    },
    "data": {"image": {"imsize": 64}, "text": {"word_num": 24}},
    "transforms": {"norm": "half", "random_crop": {"crop_size": 48}},
}
CLASSES = {
    "edema": ["mild edema at the left lung base", "edema in the lung"],
    "no finding": ["no finding"],
}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX engine, port engine, path of the reference .ckpt) on one set of weights."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    cfg = Config(CFG)
    corpus = (SyntheticPretrainingDataset(size=16, imsize=64).corpus()
              + ["atelectasis cardiomegaly edema effusion"])
    jtok = JWordPieceTokenizer.from_corpus(corpus)
    model = GLoRIA(cfg)
    txt = japi.TextProcessor(jtok, num_words=24)(["mild edema at the left lung base"])
    batch = {"imgs": np.random.RandomState(0).randn(1, 64, 64, 3).astype(np.float32),
             "caption_ids": txt["caption_ids"], "attention_mask": txt["attention_mask"],
             "token_type_ids": txt["token_type_ids"], "word_assignment": txt["word_assignment"]}
    variables = jax.tree_util.tree_map(
        np.asarray, jax.device_get(model.init(jax.random.PRNGKey(0), batch)))
    jengine = JInferenceEngine(japi.GloriaModel(cfg, variables, tokenizer=jtok), CLASSES, max_batch=8)
    gm = tapi.GloriaModel(TConfig(CFG), state_dict_from_jax(variables),
                          tokenizer=WordPieceTokenizer.from_corpus(corpus), device="cpu")
    ckpt = tmp_path_factory.mktemp("ckpt") / "model.ckpt"
    save_reference_checkpoint(ckpt, variables, cfg)
    yield jengine, InferenceEngine(gm, CLASSES, max_batch=8), ckpt
    torch.set_num_threads(prev)


def _imgs(n, seed=3):
    return np.asarray([np.random.RandomState(seed + i).randn(48, 48, 3).astype(np.float32)
                       for i in range(n)])


def _raw(n, seed=60):
    return [(np.random.RandomState(seed + i).rand(80, 66) * 255).astype(np.uint8) for i in range(n)]


def test_next_bucket():
    assert [_next_bucket(n, 8) for n in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8, 8]


def test_classify_float_matches_jax(pair):
    jeng, eng, _ = pair
    imgs = _imgs(5)
    got = eng.classify(imgs)
    assert got.shape == (5, 2) and np.isfinite(got).all()
    np.testing.assert_allclose(got, jeng.classify(imgs), rtol=0, atol=SCORE_TOL)
    np.testing.assert_allclose(eng.classify(imgs, z_normalize=True),
                               jeng.classify(imgs, z_normalize=True), rtol=0, atol=10 * SCORE_TOL)


def test_classify_uint8_matches_jax(pair):
    """Host letterbox + crop kept uint8 (identical arrays in both packages),
    normalized on the device; scores equal the float pipeline's."""
    jeng, eng, _ = pair
    u8 = eng.process_img_uint8(_raw(3))
    np.testing.assert_array_equal(u8, jeng.process_img_uint8(_raw(3)))
    assert u8.dtype == np.uint8 and u8.shape == (3, 48, 48, 3)
    got = eng.classify(u8)
    np.testing.assert_allclose(got, jeng.classify(u8), rtol=0, atol=SCORE_TOL)
    f32 = eng.model.process_img(_raw(3))
    np.testing.assert_allclose(eng.classify(f32.numpy()), got, rtol=0, atol=SAME_PACKAGE_TOL)


def test_bucket_padding_and_split(pair):
    _, eng, _ = pair
    imgs = _imgs(10)  # max_batch=8 → 8 + 2; and 3 pads to a bucket of 4
    l3, g3 = eng.encode_images(imgs[:3])
    l1, g1 = eng.encode_images(imgs[:1])
    np.testing.assert_allclose(l3[0].numpy(), l1[0].numpy(), rtol=0, atol=SAME_PACKAGE_TOL)
    np.testing.assert_allclose(g3[0].numpy(), g1[0].numpy(), rtol=0, atol=SAME_PACKAGE_TOL)
    scores = eng.classify(imgs)
    assert scores.shape == (10, 2)
    np.testing.assert_allclose(scores[:4], eng.classify(imgs[:4]), rtol=0, atol=SAME_PACKAGE_TOL)


def test_dynamic_batcher_matches_direct(pair):
    _, eng, _ = pair
    bat = DynamicBatcher(eng, max_wait_ms=20)
    try:
        odd = (np.random.RandomState(71).rand(1, 48, 48, 3) * 255).astype(np.uint8)
        reqs = [_imgs(1, seed=40 + i) for i in range(4)] + [odd, _imgs(2, seed=72)]
        futs = [bat.submit(r) for r in reqs]
        _, not_done = wait(futs, timeout=120)
        assert not not_done
        for r, f in zip(reqs, futs):
            np.testing.assert_allclose(f.result(), eng.classify(r), rtol=0, atol=SAME_PACKAGE_TOL)
    finally:
        bat.close()
    with pytest.raises(RuntimeError):
        bat.submit(_imgs(1))


def _post(port, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/classify",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_classify_healthz_stats(pair, tmp_path):
    import cv2

    jeng, eng, _ = pair
    raws = _raw(2, seed=50)
    paths = []
    for i, x in enumerate(raws):
        paths.append(str(tmp_path / f"im{i}.png"))
        cv2.imwrite(paths[-1], x)
    buf = io.BytesIO()
    np.save(buf, np.stack(raws))
    bat = DynamicBatcher(eng, max_wait_ms=5)
    server = serve_http(eng, host="127.0.0.1", port=0, batcher=bat)
    try:
        port = server.server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["ok"] and health["classes"] == list(CLASSES)
        code, out = _post(port, {"arrays_b64": base64.b64encode(buf.getvalue()).decode()})
        assert code == 200 and out["classes"] == list(CLASSES)
        np.testing.assert_allclose(np.asarray(out["scores"]),
                                   jeng.classify(jeng.process_img_uint8(raws)), rtol=0, atol=SCORE_TOL)
        code, out = _post(port, {"paths": paths})
        assert code == 200
        np.testing.assert_allclose(np.asarray(out["scores"]), eng.classify_paths(paths),
                                   rtol=0, atol=SAME_PACKAGE_TOL)
        assert _post(port, {})[0] == 400
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["requests"]["/classify"] == 3 and stats["errors"]["/classify"] == 1
        assert stats["images"] == 4 and stats["latency"]["/classify"]["n"] == 2
        assert stats["max_batch"] == 8 and stats["batcher_queue_depth"] == 0
    finally:
        server.shutdown()
        server.server_close()
        bat.close()


def test_get_similarities_and_zero_shot_match_jax(pair):
    jeng, eng, _ = pair
    jgm, gm = jeng.model, eng.model
    imgs = _imgs(3, seed=20)
    prompts = ["mild edema at the left lung base", "no finding", "edema in the lung"]
    jtxt, txt = jgm.process_text(prompts), gm.process_text(prompts)
    for kind in ("global", "local", "both"):
        got = gm.get_similarities(imgs, txt, similarity_type=kind)
        assert got.shape == (3, 3)
        np.testing.assert_allclose(got, jgm.get_similarities(imgs, jtxt, similarity_type=kind),
                                   rtol=0, atol=SCORE_TOL)
    ref = jgm.zero_shot_classification(imgs, jgm.process_class_prompts(CLASSES))
    got = gm.zero_shot_classification(imgs, gm.process_class_prompts(CLASSES))
    assert list(got.columns) == list(ref.columns)
    np.testing.assert_allclose(got.to_numpy(), ref.to_numpy(), rtol=0, atol=10 * SCORE_TOL)
    assert local_sim.launches == 0  # the CPU path never launches the kernel


def test_load_gloria_from_reference_ckpt(pair):
    jeng, _, ckpt = pair
    gm = tapi.load_gloria(str(ckpt), device="cpu", tokenizer=jeng.model.tokenizer)
    eng = InferenceEngine(gm, CLASSES, max_batch=8)
    imgs = _imgs(2, seed=30)
    np.testing.assert_allclose(eng.classify(imgs), jeng.classify(imgs), rtol=0, atol=SCORE_TOL)


def test_chexpert_prompts_match_jax():
    random.seed(6)
    ref = japi.generate_chexpert_class_prompts()
    random.seed(6)
    got = tapi.generate_chexpert_class_prompts()
    assert got == ref and len(got) == 5 and all(len(v) == 5 for v in got.values())
