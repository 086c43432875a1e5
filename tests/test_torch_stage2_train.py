"""BLIP-2 stage 2's caption training (train/generic.py, train/loop.py,
cli/train.py over models/blip2_{opt,t5}.py) against sprc_tpu's.

Both train CLIs run configs/runs/caption_coco_blip2_ft.yaml (``blip2_opt`` /
``caption_coco_opt2.7b``, whose model YAML sets ``freeze_vit: false``) and
configs/runs/pretrain_stage2.yaml (``blip2_t5`` / ``pretrain_flant5xl``, a
frozen tower) with the instruct CLI's tiny heads (test_torch_caption_cli.py:
a 28 px tower of width 32, a 2-layer Q-Former with 4 queries, the LLM
stirred as test_torch_opt.py does) over a synthetic ``coco_caption`` train
split of 12 PNG images (batch 4: 3 steps), from the same weights: the JAX
run's init is handed the tree the port's ``--model-path`` file was made from,
and its orbax checkpoint write is replaced by a no-op. The Q-Former's
dropout is 0 for the comparisons (the two packages draw their masks from
different generators); the last test trains with dropout on, in the port
alone.

Held: each step's loss within 1e-5, the parameters after the three AdamW
steps within test_torch_generic_train.py's 1e-5, the trained set equal to
the JAX optimizer's train partition name for name, every tower and LLM
tensor bit for bit unchanged (the COCO row's ``freeze_vit: false``
included), one step's gradients within 1e-4, the seq2seq collate equal to
JAX's, a ``run.tokenizer`` that names a WordLevel ``tokenizer.json``, and
no tensor under a class's ``FROZEN_PREFIXES`` ever taking a gradient.
"""

import argparse
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu.train import checkpoint as jcheckpoint  # noqa: E402
from sprc_tpu.train import generic as jgeneric  # noqa: E402
from sprc_tpu.train import runner as jrunner  # noqa: E402

from sprc_tpu_torch.interop.jax_params import state_dict_from_jax  # noqa: E402
from sprc_tpu_torch.train import generic, runner  # noqa: E402
from test_torch_caption_cli import IMG, LLM, Q, QF, VIT, VOCAB, WORDS  # noqa: E402
from test_torch_opt import jnp_tree, stir  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
GRAD_ATOL = 1e-4
# (run YAML, arch, its model type, the JAX LLM key, the port's frozen prefixes)
RUNS = {"blip2_opt": ("caption_coco_blip2_ft.yaml", "caption_coco_opt2.7b", "opt",
                      ("visual_encoder.", "opt_model.")),
        "blip2_t5": ("pretrain_stage2.yaml", "pretrain_flant5xl", "t5",
                     ("visual_encoder.", "t5_model."))}


def model_section(arch, dropout=0.0):
    _, model_type, _, _ = RUNS[arch]
    _, field, llm = LLM[arch]
    return {"arch": arch, "model_type": model_type, "image_size": IMG, "num_query_token": Q,
            "max_txt_len": 6, "vocab_size": VOCAB, "embed_dim": 16, "vit_dtype": "fp32",
            "vit_config_override": VIT, "qformer_config_override": dict(QF, dropout_rate=dropout),
            field: llm}


def jax_params(arch):
    """The JAX model of ``arch``'s tiny run config and its init, the LLM
    stirred; its train partition's top-level keys."""
    from sprc_tpu.loader import build_model

    section = model_section(arch)
    jm = build_model(section.pop("arch"), section.pop("model_type"), **section)
    img = jnp.zeros((1, IMG, IMG, 3), jnp.float32)
    ids, ones = jnp.zeros((1, 4), jnp.int32), jnp.ones((1, 4), jnp.int32)
    extra = (ids, ones) if arch == "blip2_t5" else ()
    params = jnp_tree(jm.init(jax.random.PRNGKey(0), img, ids, ones, *extra)["params"])
    llm = RUNS[arch][2]
    params[llm] = stir(params[llm])
    return jm, params


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """12 PNG images of mixed sizes with a caption each, the BERT vocab, and
    each head's weights (the JAX tree and the port's checkpoint of it)."""
    from PIL import Image

    root = tmp_path_factory.mktemp("coco_caption")
    rng = np.random.RandomState(21)
    ann = []
    for i in range(12):
        name = f"c{i:02d}.png"
        h, w = 26 + 5 * (i % 4), 40 - 4 * (i % 3)
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(root / name)
        ann.append({"image": name, "caption": " ".join(rng.choice(WORDS, 4 + i % 3)),
                    "image_id": f"i{i}"})
    (root / "train.json").write_text(json.dumps(ann))
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS + [".", ","]
    (root / "vocab.txt").write_text("\n".join(vocab))
    heads = {}
    for arch in RUNS:
        jm, params = jax_params(arch)
        ckpt = root / f"{arch}.pth"
        torch.save({"model": state_dict_from_jax(params, vit="eva_clip_g")}, ckpt)
        heads[arch] = {"jm": jm, "params": params, "ckpt": str(ckpt)}
    return {"root": str(root), "vocab": str(root / "vocab.txt"), "heads": heads}


def cli_argv(data, arch, out, *extra):
    """The train CLI's argv for ``arch``'s run YAML on the tiny head, one
    epoch of 3 steps at batch 4."""
    yaml_name = RUNS[arch][0]
    opts = [f"model.{k}={json.dumps(v)}" for k, v in model_section(arch).items()]
    ds = "datasets.coco_caption"
    return ["--cfg-path", os.path.join(ROOT, "configs", "runs", yaml_name), "--vocab-path",
            data["vocab"], "--output-dir", str(out), "--options", "run.batch_size=4",
            "run.max_epochs=1", "run.max_txt_len=8", "run.log_freq=1",
            f"{ds}.build_info.annotations.train=[{os.path.join(data['root'], 'train.json')}]",
            f"{ds}.build_info.images={data['root']}",
            f"{ds}.vis_processor.train.image_size={IMG}", *opts, *extra]


def _rows(out):
    with open(os.path.join(out, "log.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["kind"] == "step"]


def run_both(data, arch, tmp_path, monkeypatch, *extra):
    """Both CLIs on ``arch``'s run -> (JAX params after it, the port's
    model after it, the port's last_state)."""
    from sprc_tpu.cli import train as jtrain

    from sprc_tpu_torch.cli import train

    head = data["heads"][arch]
    captured = {}
    jrun, prun = jrunner.EpochRunner.train, runner.EpochRunner.train

    def keep_jax(self):
        best = jrun(self)
        captured["jax"] = jax.tree_util.tree_map(np.asarray, self.state.params)
        return best

    def keep_port(self):
        best = prun(self)
        captured["port"] = self.model
        return best

    monkeypatch.setattr(jrunner.EpochRunner, "train", keep_jax)
    monkeypatch.setattr(runner.EpochRunner, "train", keep_port)
    monkeypatch.setattr(jcheckpoint, "save_state", lambda path, state: None)
    for cls in (jgeneric.CaptionAdapter, jgeneric.Seq2SeqCaptionAdapter):
        monkeypatch.setattr(cls, "init_params", lambda self, model, rng, size: head["params"],
                            raising=False)
    jtrain.main(cli_argv(data, arch, tmp_path / "jax", *extra))
    train.main(cli_argv(data, arch, tmp_path / "port", *extra) + ["--model-path", head["ckpt"],
                                                                   "--device", "cpu"])
    want, got = _rows(tmp_path / "jax"), _rows(tmp_path / "port")
    assert [r["step"] for r in got] == [r["step"] for r in want] == [0, 1, 2]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert abs(g["loss"] - w["loss"]) <= ATOL * abs(w["loss"]), (g["step"], g, w)
    state = torch.load(tmp_path / "port" / "last_state.pt", weights_only=True)
    return captured["jax"], captured["port"], state


@pytest.mark.parametrize("arch", list(RUNS))
def test_cli_train_equals_jax(arch, data, tmp_path, monkeypatch):
    """The run YAML through both train CLIs: the losses of 3 steps, the
    parameters after them, the trained set against JAX's train partition,
    and every tower and LLM tensor unchanged bit for bit (the OPT row's
    YAML sets freeze_vit false; JAX's partition freezes the tower all the
    same)."""
    jax_after, model, state = run_both(data, arch, tmp_path, monkeypatch)
    head = data["heads"][arch]
    _, _, llm, frozen = RUNS[arch]
    assert state["updates"] == 3 and state["decayed"] == {}
    start = state_dict_from_jax(head["params"], vit="eva_clip_g")
    # JAX's train partition (the top-level keys outside its FROZEN_PREFIXES)
    # mapped name for name: every leaf of it 1, every frozen leaf 0, through
    # the bridge
    jfrozen = set(type(head["jm"]).FROZEN_PREFIXES)
    assert jfrozen == {"visual_encoder", llm}
    marked = state_dict_from_jax(
        {k: jax.tree_util.tree_map(lambda v, on=k not in jfrozen: np.full(np.shape(v), on,
                                                                         np.float32), sub)
         for k, sub in head["params"].items()}, vit="eva_clip_g")
    train_names = {n for n, t in marked.items() if bool((t == 1).all())}
    assert set(state["trainable"]) == train_names
    assert {n.split(".")[0] for n in train_names} == {
        "query_tokens", "temp", "ln_vision", "Qformer", f"{llm}_proj"}
    want = state_dict_from_jax(jax_after, vit="eva_clip_g")
    for name, value in state["trainable"].items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), atol=ATOL, err_msg=name)
    moved = max((state["trainable"][n] - start[n]).abs().max().item() for n in train_names)
    assert moved > 1e-6
    after = model.state_dict()
    frozen_names = [n for n in start if n.startswith(frozen)]
    params = dict(model.named_parameters())
    assert frozen_names and not any(params[n].requires_grad for n in frozen_names if n in params)
    for name in frozen_names:
        assert torch.equal(after[name], start[name]), name
        assert np.array_equal(np.asarray(want[name]), np.asarray(start[name])), name
    if arch == "blip2_opt":
        assert not model.cfg.freeze_vit and model.tower_frozen


@pytest.mark.parametrize("arch", list(RUNS))
def test_step_gradients_equal_jax(arch, data):
    """One step's loss and every trainable gradient (opt_proj / t5_proj and
    the Q-Former's last layer among them) against ``jax.grad`` of the JAX
    adapter's loss over the train partition, through the frozen LLM."""
    from sprc_tpu_torch import loader
    from sprc_tpu_torch.data import builders  # noqa: F401  (registers them)
    from sprc_tpu_torch.registry import registry
    from sprc_tpu_torch.text.tokenizer import BertWordPieceTokenizer
    from sprc_tpu_torch.train.loop import TrainConfig

    head = data["heads"][arch]
    jm, params = head["jm"], head["params"]
    section = model_section(arch)
    model = loader.load_model(section.pop("arch"), section.pop("model_type"),
                              checkpoint_path=head["ckpt"], device="cpu", **section)
    tok = BertWordPieceTokenizer.from_vocab_file(data["vocab"])
    adapter = generic.CaptionAdapter(tok, max_txt_len=8).specialize(model)
    ds = registry.get("dataset", "coco_caption")({
        "build_info": {"annotations": {"train": [os.path.join(data["root"], "train.json")]},
                       "images": data["root"]},
        "vis_processor": {"train": {"name": "blip_image_eval", "image_size": IMG}},
        "text_processor": {"train": {"name": "blip_caption"}}}).build()["train"]
    batch = adapter.collate([ds[i] for i in range(4)])
    trainer = generic.GenericTrainer(model, TrainConfig(), adapter=adapter)
    total, losses, grads = trainer.loss_and_grads(
        {k: torch.as_tensor(v) for k, v in batch.items()})
    assert set(losses) == {"loss"}

    japply = jgeneric.CaptionAdapter(tok, max_txt_len=8).specialize(jm).loss_fn(jm)
    frozen = set(type(jm).FROZEN_PREFIXES)
    train = {k: v for k, v in params.items() if k not in frozen}
    rest = {k: v for k, v in params.items() if k in frozen}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.value_and_grad(
        lambda t: japply({**t, **rest}, jbatch, jax.random.PRNGKey(0))["loss"])(train)
    assert abs(total.item() - float(jloss)) <= ATOL * abs(float(jloss))
    want = state_dict_from_jax({**jax.tree_util.tree_map(np.asarray, jgrads),
                                **jax.tree_util.tree_map(np.zeros_like, rest)}, vit="eva_clip_g")
    llm = RUNS[arch][2]
    checked = set()
    for name, g in zip(trainer.names, grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=GRAD_ATOL, rtol=0,
                                   err_msg=name)
        checked.add(name)
    last = f"Qformer.bert.encoder.layer.{QF['num_layers'] - 1}."
    assert any(n.startswith(f"{llm}_proj.") for n in checked)
    assert any(n.startswith(last) for n in checked)
    assert max(want[n].abs().max().item() for n in checked if n.startswith(f"{llm}_proj.")) > 1e-3


def test_seq2seq_collate_and_run_tokenizer_equal_jax(data, tmp_path, monkeypatch):
    """The seq2seq collate (the prompt "" at max_length 4 into the encoder,
    the caption into the decoder) equals JAX's, with the BERT tokenizer and
    with a WordLevel tokenizer.json named by ``run.tokenizer``; the T5 run
    through both CLIs with that tokenizer (its pad 0 the decoder's start)."""
    tokenizers = pytest.importorskip("tokenizers")
    from sprc_tpu.text.llm_tokenizers import t5_tokenizer as jt5
    from sprc_tpu.text.tokenizer import BertWordPieceTokenizer as JBert

    from sprc_tpu_torch.text.llm_tokenizers import t5_tokenizer
    from sprc_tpu_torch.text.tokenizer import BertWordPieceTokenizer

    vocab = {"<pad>": 0, "</s>": 1, "<unk>": 2, **{w: 3 + i for i, w in enumerate(WORDS)}}
    tok = tokenizers.Tokenizer(tokenizers.models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.Whitespace()
    path = tmp_path / "tokenizer.json"
    tok.save(str(path))
    items = [{"image": np.full((IMG, IMG, 3), i, np.float32),
              "text_input": " ".join(WORDS[i: i + 3 + i])} for i in range(3)]
    for port_tok, jax_tok in ((BertWordPieceTokenizer.from_vocab_file(data["vocab"]),
                               JBert.from_vocab_file(data["vocab"])),
                              (t5_tokenizer(str(path)), jt5(str(path)))):
        got = generic.Seq2SeqCaptionAdapter(port_tok, max_txt_len=8).collate(items)
        want = jgeneric.Seq2SeqCaptionAdapter(jax_tok, max_txt_len=8).collate(items)
        assert set(got) == set(want) == {"images", "input_ids", "input_mask", "output_ids",
                                         "output_mask"}
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    run_both(data, "blip2_t5", tmp_path, monkeypatch, f"run.tokenizer={{t5: {path}}}")


def test_dropout_moves_the_loss_and_reproduces_under_its_seed(data):
    """With the Q-Former's dropout at 0.5, one step's loss differs from the
    loss without dropout, two trainers of one seed give it bit for bit, and
    another seed moves it (the port alone: JAX draws its masks from its own
    generator)."""
    from sprc_tpu_torch import loader
    from sprc_tpu_torch.train.loop import TrainConfig

    def model(dropout):
        section = model_section("blip2_opt", dropout=dropout)
        return loader.load_model(section.pop("arch"), section.pop("model_type"),
                                 checkpoint_path=data["heads"]["blip2_opt"]["ckpt"],
                                 device="cpu", **section)

    rng = np.random.RandomState(4)
    batch = {"images": torch.from_numpy(rng.rand(3, IMG, IMG, 3).astype(np.float32)),
             "input_ids": torch.from_numpy(rng.randint(5, VOCAB, (3, 6))),
             "text_mask": torch.ones(3, 6, dtype=torch.long)}

    def loss(m, seed):
        return generic.GenericTrainer(m, TrainConfig(), seed=seed).loss_and_grads(batch)[0]

    on = model(0.5)
    first, again, other = loss(on, 0), loss(on, 0), loss(on, 1)
    assert torch.equal(first, again) and first.item() != other.item()
    assert abs(loss(model(0.0), 0).item() - first.item()) > 1e-6


def test_frozen_prefixes_never_take_a_gradient():
    """Every registered class that sets ``FROZEN_PREFIXES`` turns
    ``requires_grad`` off for each tensor under them when it is built,
    whatever ``freeze_vit`` says, and the trainer (which selects on
    ``requires_grad`` alone) holds none of them; training mode keeps a tower
    so frozen in eval mode."""
    from sprc_tpu_torch import loader
    from sprc_tpu_torch.registry import registry
    from sprc_tpu_torch.train.loop import TrainConfig, Trainer

    with_prefixes = {n for n in registry.list("model")
                     if getattr(registry.get_model_class(n), "FROZEN_PREFIXES", ())}
    assert with_prefixes == {"blip2_opt", "blip2_t5", "blip2_t5_instruct", "blip2_cir_rerank",
                             "blip2_vicuna_instruct", "blip2_instruct_cir"}
    tiny = dict(image_size=IMG, num_query_token=Q, max_txt_len=6, vocab_size=VOCAB, embed_dim=16,
                vit_config_override=VIT, qformer_config_override=QF)
    builds = [("blip2_cir_rerank", dict(tiny, model_type="pretrain"))]
    builds += [(arch, dict(tiny, model_type="vicuna7b", freeze_vit=False,
                           llama_config=dict(vocab_size=80, hidden_size=48, intermediate_size=96,
                                             num_layers=2, num_heads=4)))
               for arch in ("blip2_vicuna_instruct", "blip2_instruct_cir")]
    builds += [(arch, dict(model_section(arch), freeze_vit=freeze))
               for arch in RUNS for freeze in (False, True)]
    for arch, section in builds:
        section = {k: v for k, v in section.items() if k != "arch"}
        model = loader.load_model(arch, section.pop("model_type"), device="cpu", **section)
        prefixes = type(model).FROZEN_PREFIXES
        frozen = [n for n, _ in model.named_parameters() if n.startswith(prefixes)]
        assert frozen, arch
        params = dict(model.named_parameters())
        assert not any(params[n].requires_grad for n in frozen), (arch, section)
        names = Trainer(model, TrainConfig()).names
        assert names and not any(n.startswith(prefixes) for n in names), arch
        assert set(names) == {n for n, p in params.items() if p.requires_grad}
        if "visual_encoder" in prefixes:
            assert model.tower_frozen and not model.train().visual_encoder.training, arch


def test_train_refuses_what_is_not_ported(data, tmp_path):
    """``run.tokenizer`` llama reads its tokenizer.json (a missing one is a
    FileNotFoundError that names it); the LLaMA models have no generic
    adapter; no captioning adapter fits ALPRO's video forward, in either
    package (ALPRO's retrieval and QA train: test_torch_alpro_cli.py;
    BLIP-1's captioner, once refused, trains:
    test_torch_blip_caption_cli.py); VQA training refuses a model that is
    not BLIP-1 / ALBEF's."""
    from sprc_tpu_torch.config import Config

    args = argparse.Namespace(output_dir=str(tmp_path), vocab_path=data["vocab"], device="cpu")
    cfg = yaml.safe_load(open(os.path.join(ROOT, "configs", "runs", "caption_coco_blip2_ft.yaml")))
    cfg["model"] = model_section("blip2_opt")
    cfg["datasets"]["coco_caption"]["build_info"] = {
        "annotations": {"train": [os.path.join(data["root"], "train.json")]},
        "images": data["root"]}
    cfg["run"]["tokenizer"] = {"llama": str(tmp_path / "missing" / "tokenizer.json")}
    with pytest.raises(FileNotFoundError, match="missing/tokenizer.json"):
        generic.run_generic(Config(defaults=cfg), args)
    for arch in ("blip2_vicuna_instruct", "blip2_instruct_cir"):
        with pytest.raises(SystemExit, match="no generic task adapter fits its forward"):
            generic.run_generic(Config(defaults=dict(cfg, model={"arch": arch,
                                                                 "model_type": "vicuna7b"})),
                                args)
    for run, model, refusal in (
            ({"task": "captioning"}, {"arch": "alpro_retrieval"},
             "fits its video forward, in either package"),
            ({"task": "vqa"}, {"arch": "blip2_opt"}, "trains BLIP-1 / ALBEF's VQA models")):
        with pytest.raises(SystemExit, match=refusal):
            generic.run_generic(Config(defaults={"run": run, "model": model}), args)
