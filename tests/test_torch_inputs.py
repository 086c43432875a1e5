"""The port's copies of the framework-free input code equal sprc_tpu's:
tokenizer ids, the synthetic vocab and targetpad pixels (the CIRR dataset
and the gallery batch stream are in test_torch_data.py).
"""

import numpy as np
import pytest

from sprc_tpu.data.transforms import targetpad_transform as jax_targetpad
from sprc_tpu.text.tokenizer import BertWordPieceTokenizer as JTokenizer
from sprc_tpu.utils.artifacts import write_synthetic_bert_vocab as jax_write_vocab

from sprc_tpu_torch.data.transforms import targetpad_transform
from sprc_tpu_torch.text.tokenizer import BertWordPieceTokenizer
from sprc_tpu_torch.utils.artifacts import ensure_bert_vocab, write_synthetic_bert_vocab
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

CAPTIONS = ["Is red and has long sleeves", "no dog!", "Café-au-lait coloured, 3 buttons",
            "", "x" * 120, "[CLS] literal specials [SEP]"]


@pytest.fixture(scope="module")
def vocab_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("vocab")
    return (write_synthetic_bert_vocab(str(d / "port.txt")),
            jax_write_vocab(str(d / "jax.txt")))


def test_synthetic_vocab_identical(vocab_files):
    port, jax_file = vocab_files
    with open(port, "rb") as a, open(jax_file, "rb") as b:
        assert a.read() == b.read()
    assert ensure_bert_vocab(port) == port
    with pytest.raises(FileNotFoundError):
        ensure_bert_vocab(port + ".missing")


@pytest.mark.parametrize("max_length", [8, 32])
def test_tokenizer_ids_identical(vocab_files, max_length):
    port = BertWordPieceTokenizer.from_vocab_file(vocab_files[0])
    ref = JTokenizer.from_vocab_file(vocab_files[0])
    got, want = port(CAPTIONS, max_length=max_length), ref(CAPTIONS, max_length=max_length)
    for key in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(got[key], want[key])
    assert [port.tokenize(c) for c in CAPTIONS] == [ref.tokenize(c) for c in CAPTIONS]


@pytest.mark.parametrize("size", [(40, 30), (30, 90), (64, 64)])
def test_targetpad_pixels_identical(size):
    import PIL.Image

    rng = np.random.RandomState(sum(size))
    img = PIL.Image.fromarray((rng.rand(size[1], size[0], 3) * 255).astype(np.uint8))
    got = targetpad_transform(1.25, 32)(img)
    assert got.shape == (32, 32, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_targetpad(1.25, 32)(img))
