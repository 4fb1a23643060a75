"""The port's CLIP text tower (`ov3det_torch/models/clip_text.py`) and
`tools/extract_class_features.py` on the CPU against the JAX package's.

- The JAX `CLIPTextEncoder` (2 layers, width 64) and the port's, its
  parameters carried across by `from_flax_text_variables`: embeddings
  within 1e-5 (f32), on prompts whose EOT sits at different positions;
- `convert_text_checkpoint` on a random state dict in CLIP's torch layout
  (a live torch oracle, as `tests/test_convert.py` builds one), bare and as
  a RegionCLIP `{"model": {"lang_encoder.*"}}` file, 2 and 3 blocks: the
  port reads the depth from the file and equals the oracle and JAX's
  converted tower within 1e-5;
- the tokenizer's ids equal JAX's on a stub merges file (the real
  vocabulary is not in the repository);
- `extract_class_features.main` writes, from one checkpoint and
  vocabulary, what JAX's writes (within 1e-5; the port reads the tower's
  sizes from the checkpoint, JAX takes them as flags), and
  `load_text_embed` loads it into the detector's frozen head.
"""
import gzip

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from ov3det_torch.models import clip_text as T

SCANNET = ["cabinet", "bed", "chair", "sofa", "table", "door", "window", "bookshelf", "picture",
           "counter", "desk", "curtain", "refrigerator", "shower curtain", "toilet", "sink",
           "bathtub", "garbage bin"]


@pytest.fixture(autouse=True)
def _setup():
    torch.set_num_threads(1)


def stub_vocab(path) -> str:
    """A merges file of a few merges, in the layout of CLIP's."""
    merges = ["#version: 0.2", "h e", "l l", "he ll", "hell o</w>", "c h", "a i", "ch ai",
              "chai r</w>", "t a", "ta b", "tab l", "tabl e</w>", "p h", "o t", "ph ot",
              "phot o</w>", "o f</w>", "t h", "th e</w>"]
    with gzip.open(path, "wt", encoding="utf-8") as fh:
        fh.write("\n".join(merges) + "\n")
    return str(path)


def _ids(rng, B, T_, vocab, eot_at):
    ids = rng.integers(1, vocab - 2, (B, T_)).astype(np.int32)
    ids[:, 0] = vocab - 2
    for b, e in enumerate(eot_at):
        ids[b, e] = vocab - 1  # EOT: the highest id, argmax-pooled
        ids[b, e + 1:] = 0
    return ids


def test_text_tower_matches_jax():
    from ov3det.models.clip_text import CLIPTextEncoder as JEnc
    from ov3det_torch.models.convert import from_flax_text_variables

    kw = dict(vocab_size=100, context_length=16, width=64, heads=2, layers=2, embed_dim=32)
    ids = _ids(np.random.default_rng(0), 4, 16, 100, [3, 15, 7, 1])
    enc = JEnc(**kw)
    variables = jax.tree_util.tree_map(np.asarray, enc.init(jax.random.PRNGKey(1),
                                                            jnp.asarray(ids)))
    # nonzero biases and LayerNorm affines, so that every mapped leaf counts
    rng = np.random.default_rng(2)
    variables = jax.tree_util.tree_map(
        lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32), variables)
    want = np.asarray(enc.apply(variables, jnp.asarray(ids)))
    port = T.CLIPTextEncoder(**kw, device="cpu")
    port.load_state_dict(from_flax_text_variables(variables))
    with torch.no_grad():
        got = port(torch.from_numpy(ids)).numpy()
    assert got.shape == (4, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


class _Block(nn.Module):
    def __init__(self, width, heads):
        super().__init__()
        self.attn = nn.MultiheadAttention(width, heads)
        self.ln_1 = nn.LayerNorm(width)
        self.mlp = nn.Sequential()
        self.mlp.add_module("c_fc", nn.Linear(width, width * 4))
        self.mlp.add_module("gelu", T.QuickGELU())
        self.mlp.add_module("c_proj", nn.Linear(width * 4, width))
        self.ln_2 = nn.LayerNorm(width)

    def forward(self, x, mask):
        y = self.ln_1(x)
        x = x + self.attn(y, y, y, need_weights=False, attn_mask=mask)[0]
        return x + self.mlp(self.ln_2(x))


class ClipOracle(nn.Module):
    """CLIP's torch text tower (openai/CLIP model.py `encode_text`)."""

    def __init__(self, vocab, ctx, width, layers, embed, seed=7):
        super().__init__()
        torch.manual_seed(seed)
        self.ctx = ctx
        self.token_embedding = nn.Embedding(vocab, width)
        self.positional_embedding = nn.Parameter(torch.randn(ctx, width) * 0.01)
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList(_Block(width, width // 64)
                                                   for _ in range(layers))
        self.ln_final = nn.LayerNorm(width)
        self.text_projection = nn.Parameter(torch.randn(width, embed) * width ** -0.5)
        with torch.no_grad():  # nonzero biases and affines
            for name, p in self.named_parameters():
                if name.endswith("bias") or "ln" in name:
                    p.add_(0.1 * torch.randn(p.shape))
        self.eval()

    def forward(self, ids):
        x = self.token_embedding(ids) + self.positional_embedding
        mask = torch.full((self.ctx, self.ctx), float("-inf")).triu(1)
        x = x.permute(1, 0, 2)
        for blk in self.transformer.resblocks:
            x = blk(x, mask)
        x = self.ln_final(x.permute(1, 0, 2))
        return x[torch.arange(x.shape[0]), ids.argmax(dim=-1)] @ self.text_projection


@pytest.mark.parametrize("layers", [2, 3])
@pytest.mark.parametrize("layout", ["clip", "regionclip"])
def test_convert_text_checkpoint_matches_oracle_and_jax(tmp_path, layout, layers):
    from ov3det.models.clip_text import CLIPTextEncoder as JEnc
    from ov3det.models.clip_text import convert_text_checkpoint as jax_convert

    vocab, ctx, width, embed = 100, 16, 64, 32
    oracle = ClipOracle(vocab, ctx, width, layers, embed)
    ids = _ids(np.random.default_rng(3), 3, ctx, vocab, [4, 9, 15])
    with torch.no_grad():
        want = oracle(torch.from_numpy(ids).long()).numpy()
    sd = oracle.state_dict()
    if layout == "regionclip":
        sd = {"model": {f"lang_encoder.{k}": v for k, v in sd.items()}}
    path = tmp_path / "text.pth"
    torch.save(sd, path)

    port = T.CLIPTextEncoder(vocab_size=vocab, context_length=ctx, width=width, heads=1,
                             layers=layers, embed_dim=embed, device="cpu")
    state = T.convert_text_checkpoint(str(path))  # the depth read from the checkpoint
    assert sum(n.endswith(".attn.in_proj_weight") for n in state) == layers
    port.load_state_dict(state)
    with torch.no_grad():
        got = port(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    jenc = JEnc(vocab_size=vocab, context_length=ctx, width=width, heads=1, layers=layers,
                embed_dim=embed)
    jax_out = np.asarray(jenc.apply(jax_convert(str(path), layers=layers), jnp.asarray(ids)))
    np.testing.assert_allclose(got, jax_out, rtol=0, atol=1e-5)


def test_tokenizer_ids_equal_jax(tmp_path):
    from ov3det.models.clip_text import PROMPT_TEMPLATES as JTEMPLATES
    from ov3det.models.clip_text import SimpleBPETokenizer as JTok
    from ov3det.models.clip_text import tokenize_prompts as jax_tokenize

    path = stub_vocab(tmp_path / "bpe.txt.gz")
    jt, tt = JTok(path), T.SimpleBPETokenizer(path)
    assert T.PROMPT_TEMPLATES == JTEMPLATES
    texts = ["hello", "a photo of the chair.", "Table &amp; CHAIR's  legs!", "x" * 200, ""]
    assert [tt.encode(s) for s in texts] == [jt.encode(s) for s in texts]
    np.testing.assert_array_equal(tt(texts), jt(texts))
    want = jax_tokenize(SCANNET, jt)
    got = T.tokenize_prompts(SCANNET, tt)
    assert got.shape == (18, len(JTEMPLATES), 77) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert tt.encode("hello") == [tt.encoder["hello</w>"]]  # merged by rank


def test_extract_class_features_writes_what_load_text_embed_loads(tmp_path):
    import dataclasses

    from ov3det.tools.extract_class_features import main as jax_main
    from ov3det_torch.config import ModelConfig
    from ov3det_torch.main import load_text_embed
    from ov3det_torch.models.detr3d import Model3DETR
    from ov3det_torch.tools.extract_class_features import main

    # the RN50x4 vocabulary and context at width 64: the JAX tower's sizes
    # are its defaults
    oracle = ClipOracle(49408, 77, 64, 2, 32)
    torch.save({"model": {f"lang_encoder.{k}": v for k, v in oracle.state_dict().items()}},
               tmp_path / "rc.pth")
    (tmp_path / "concepts.txt").write_text("\n".join(SCANNET + ["background"]) + "\n")
    vocab = stub_vocab(tmp_path / "bpe.txt.gz")
    common = ["--concepts", str(tmp_path / "concepts.txt"), "--clip_ckpt", str(tmp_path / "rc.pth"),
              "--bpe_vocab", vocab, "--heads", "1"]
    # the port reads width, depth and projection from the checkpoint
    got = main(common + ["--out", str(tmp_path / "port.npy"), "--device", "cpu"])
    jax_main(common + ["--width", "64", "--layers", "2", "--embed_dim", "32",
                       "--out", str(tmp_path / "jax.npy")])
    port, want = np.load(tmp_path / "port.npy"), np.load(tmp_path / "jax.npy")
    assert port.shape == (19, 32) and port.dtype == np.float32
    np.testing.assert_array_equal(port, got)
    np.testing.assert_allclose(port, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(port, axis=-1), 1.0, rtol=1e-5)

    model = Model3DETR(dataclasses.replace(ModelConfig(), clip_embed_dim=32), device="cpu")
    load_text_embed(model, str(tmp_path / "port.npy"))
    np.testing.assert_array_equal(model.text_embed.numpy(), port)


def test_text_tower_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.CLIPTextEncoder(layers=1, width=64, heads=1, vocab_size=10, context_length=4)
