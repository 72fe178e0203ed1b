"""The weights bridge: ``state_dict_from_jax`` ≡ ``export_gloria`` without the
``gloria.`` prefix, bit for bit, and both loaders take it with strict=True."""

import numpy as np
import torch

import jax

from gloria_tpu.configs import Config
from gloria_tpu.models import GLoRIA
from gloria_tpu.utils.torch_export import export_gloria, save_reference_checkpoint
from gloria_tpu_torch import api as tapi
from gloria_tpu_torch.models.gloria_model import GLoRIA as TGLoRIA
from gloria_tpu_torch.utils.weights import state_dict_from_jax


def full_featured_cfg():
    return Config({
        "model": {
            "gloria": {"temp1": 4.0, "temp2": 5.0, "temp3": 10.0, "no_attn_vec": True},
            "vision": {"model_name": "resnet_18"},
            "image_position_embeddings": {"num": 361},
            "image_transformer": {"num_layers": 2, "num_heads": 4},
            "text": {"embedding_dim": 32, "last_n_layers": 4, "agg_tokens": True,
                     "aggregate_method": "sum",
                     "bert_config": {"vocab_size": 128, "hidden_size": 32, "num_layers": 2,
                                     "num_heads": 4, "intermediate_size": 64,
                                     "max_position_embeddings": 48}},
        },
        "data": {"image": {"imsize": 64}, "text": {"word_num": 16}},
        "transforms": {"norm": "half", "random_crop": {"crop_size": 48}},
    })


def _variables(cfg, seed=0):
    B, T = 2, 16
    batch = {"imgs": np.zeros((B, 48, 48, 3), np.float32),
             "caption_ids": np.ones((B, T), np.int32), "attention_mask": np.ones((B, T), np.int32),
             "token_type_ids": np.zeros((B, T), np.int32),
             "word_assignment": np.eye(T, dtype=np.float32)[None].repeat(B, 0)}
    variables = GLoRIA(cfg).init(jax.random.PRNGKey(seed), batch)
    return jax.tree_util.tree_map(np.asarray, jax.device_get(variables))


def test_bridge_equals_export_bit_for_bit():
    variables = _variables(full_featured_cfg())
    ref = {k[len("gloria."):]: np.asarray(v) for k, v in export_gloria(variables).items()}
    got = state_dict_from_jax(variables)
    assert set(got) == set(ref)
    for k, v in ref.items():
        g = got[k].numpy()
        assert g.dtype == v.dtype and g.shape == v.shape, k
        np.testing.assert_array_equal(g, v, err_msg=k)
    model = TGLoRIA(full_featured_cfg())
    model.load_state_dict(got, strict=True)
    assert set(model.state_dict()) == set(ref)


def test_reference_checkpoint_loads_strict(tmp_path):
    """A reference-format .ckpt (``save_reference_checkpoint``), plus the BN
    ``num_batches_tracked`` counters that zoo checkpoints carry, loads
    through ``load_gloria`` with every tensor intact."""
    cfg = full_featured_cfg()
    variables = _variables(cfg, seed=1)
    path = tmp_path / "ref.ckpt"
    save_reference_checkpoint(path, variables, cfg)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    ckpt["state_dict"]["gloria.img_encoder.model.bn1.num_batches_tracked"] = torch.tensor(1000)
    torch.save(ckpt, path)
    gm = tapi.load_gloria(str(path), device="cpu")
    sd = gm.model.state_dict()
    for k, v in state_dict_from_jax(variables).items():
        np.testing.assert_array_equal(sd[k].numpy(), v.numpy(), err_msg=k)
    assert gm.cfg.model.vision.model_name == "resnet_18"
