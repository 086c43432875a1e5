"""The port's gallery batch stream (sprc_tpu_torch/data/loader.py through
cli/validate.py::index_batches): batches keep the dataset's order, the last
one is ragged, and a sample that fails to load raises from the stream.
"""

import numpy as np
import pytest

from sprc_tpu_torch.cli.validate import index_batches
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)


class _Items:
    """n samples; loading index ``bad`` raises."""

    def __init__(self, n, bad=None):
        self.n, self.bad = n, bad

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.bad:
            raise OSError(f"unreadable sample {i}")
        return {"image_name": f"n{i}", "image": np.full((2, 2, 3), i, np.float32)}


def test_index_batches_keep_order_and_ragged_tail():
    batches = list(index_batches(_Items(11), 3, 3))
    assert [len(n) for n, _ in batches] == [3, 3, 3, 2]
    assert [x for n, _ in batches for x in n] == [f"n{i}" for i in range(11)]
    np.testing.assert_array_equal(np.concatenate([im[:, 0, 0, 0] for _, im in batches]),
                                  np.arange(11, dtype=np.float32))


def test_index_batches_raise_on_a_failing_sample():
    """A sample that fails to load ends the stream with its error; the
    gallery is never cut short without a word."""
    with pytest.raises(OSError, match="unreadable sample 6"):
        list(index_batches(_Items(10, bad=6), 4, 2))


def test_load_model_reads_the_released_checkpoint_layouts(tmp_path):
    """``{epoch, ClassName: state_dict}``, ``{"model": ...}`` and a bare state
    dict all load; keys the model has no module for (the LM head of a
    released file) are dropped; a weight that is missing still raises."""
    import torch

    from sprc_tpu_torch.loader import load_model

    ovr = dict(device="cpu", image_size=28, num_query_token=4, max_txt_len=8, embed_dim=16,
               vit_dtype="fp32",
               vit_config_override=dict(image_size=28, patch_size=14, width=32, depth=1,
                                        num_heads=2, mlp_hidden=64, qkv_fused_no_kbias=True,
                                        dtype="fp32", scan_blocks=False),
               qformer_config_override=dict(vocab_size=60, hidden_size=32, num_layers=2,
                                            num_heads=2, intermediate_size=64, encoder_width=32,
                                            query_length=4, dropout_rate=0.0))
    source = load_model("blip2_cir_align_prompt", seed=1, **ovr)
    state = {k: v.clone() for k, v in source.state_dict().items()}
    extras = {"Qformer.cls.predictions.bias": torch.zeros(60), "temp": state["temp"].reshape(1)}
    files = {"released": {"epoch": 5, "Blip2QformerCirAlignPrompt": {**state, **extras}},
             "pretrained": {"model": state}, "bare": state}
    for name, payload in files.items():
        torch.save(payload, tmp_path / f"{name}.pt")
        loaded = load_model("blip2_cir_align_prompt", "pretrain", str(tmp_path / f"{name}.pt"),
                            **ovr)
        assert list(loaded.state_dict()) == list(state)
        for key, value in loaded.state_dict().items():
            assert torch.equal(value, state[key]), (name, key)
    state.pop("visual_encoder.blocks.0.attn.q_bias")
    torch.save({"epoch": 1, "Blip2QformerCirAlignPrompt": state}, tmp_path / "short.pt")
    with pytest.raises(RuntimeError, match="Missing key"):
        load_model("blip2_cir_align_prompt", "pretrain", str(tmp_path / "short.pt"), **ovr)
    with pytest.raises(TypeError):  # an unknown field is refused, not dropped
        load_model("blip2_cir_align_prompt", **{**ovr, "vit_config_override": {"widht": 32}})
