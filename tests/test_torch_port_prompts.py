"""Prompt weighting, long prompts and textual inversion: the port vs the JAX
package, on the CPU (f32), through the tiny models of
``test_torch_port_slice.py`` (one JAX model for the module).

Token ids and weights are held equal, on a grammar set that covers nesting,
escapes, unbalanced brackets and explicit weights, and on chunked batches
(a mixed batch, ``num_chunks`` pinning K up and down); embeddings to 1e-4
(f32 through the text tower, as the slice test holds ``encode_prompts``):
``encode_prompts`` on weighted, long and weighted-long prompts and on a
weighted negative prompt, and textual inversion with its placeholder twice
in the prompt, registered directly and loaded from a checkpoint in the
port's layout.
"""

import json

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402

from stable_diffusion_pytorch_tpu.models import prompt_weighting as jax_pw  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models import prompt_weighting as port_pw  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.utils.checkpoint import save_checkpoint  # noqa: E402
from test_torch_port_slice import models  # noqa: E402,F401  (module-scoped tiny JAX + port models)

torch.set_num_threads(2)
EMB = dict(rtol=1e-4, atol=1e-4)
GRAMMAR = [
    "a (red:1.5) cat",
    "((nested (deep) words)) and [low] plain",
    "[[twice down]] ((twice up))",
    "escaped \\(paren\\) and \\[bracket\\] stay literal",
    "unbalanced ( opener runs to the end",
    "stray closers ) and ] are text",
    "(a:0.5) (b:1.2) (c:-0.3) colon: text",
    "(open explicit:1.3",
    "(mixed [inner] (outer:0.8) end)",
    "no syntax at all",
    "",
]
WORDS = ("red green blue cat dog horse astronaut riding photo of a the on with under painting "
         "oil sketch bright dark").split()


def _long(chunks: int, seed: int, weighted: bool = False) -> str:
    """Random words whose body needs ``chunks`` windows of 75 tokens (by the
    offline BPE, about 20 tokens into the last)."""
    from stable_diffusion_pytorch_tpu_torch.models.bpe import CLIPBPETokenizer

    encode, rng, words = CLIPBPETokenizer(max_seq_len=77).encode, np.random.default_rng(seed), []
    while len(encode(" ".join(words))) < 75 * (chunks - 1) + 20:
        words.append(WORDS[rng.integers(0, len(WORDS))])
    n_words = len(words)
    if weighted:
        words[3] = f"({words[3]}:1.4)"
        words[n_words // 2] = f"[[{words[n_words // 2]}]]"
        words[-2] = f"(({words[-2]}))"
    return " ".join(words)


LONG = _long(2, 0)
WEIGHTED_LONG = _long(3, 1, True)


def test_grammar_is_the_jax_grammar():
    for prompt in GRAMMAR + [LONG, WEIGHTED_LONG]:
        assert port_pw.parse_weighted_prompt(prompt) == jax_pw.parse_weighted_prompt(prompt), prompt
        assert port_pw.has_weight_syntax(prompt) == jax_pw.has_weight_syntax(prompt)
        assert port_pw.plain_text(prompt) == jax_pw.plain_text(prompt)


def test_fragment_tokenization_matches_jax(models):
    """A single ragged row from the port's BPE comes back whole, so the
    fragment ids (no specials) are JAX's, also where brackets split a word."""
    jax_model, port_model = models
    jte, pte = jax_model.text_encoder, port_model.text_encoder
    row = pte.tokenizer("a photograph of an astronaut", max_length=10_000, padding=False, truncation=False)
    assert np.asarray(row.input_ids).shape == (1, len(pte._plain_ids("a photograph of an astronaut")) + 2)
    for text in ["a photograph of an astronaut", "   ", "red", LONG, "(red:1.5) cat"]:
        assert pte._plain_ids(text) == jte._plain_ids(text)
    # fragment by fragment: the row of "(red:1.5) cat" joins the ids of "red" and " cat"
    ids, _ = pte.tokenize_weighted(["(red:1.5) cat"])
    body = pte._plain_ids("red") + pte._plain_ids(" cat")
    assert list(ids.input_ids[0, :len(body) + 2]) == [49406, *body, 49407]


def test_tokenize_weighted_ids_and_weights_equal_jax(models):
    jax_model, port_model = models
    jte, pte = jax_model.text_encoder, port_model.text_encoder
    prompts = GRAMMAR + [LONG, WEIGHTED_LONG]  # the long ones truncated to 77
    p_ids, p_w = pte.tokenize_weighted(prompts)
    j_ids, j_w = jte.tokenize_weighted(prompts)
    np.testing.assert_array_equal(p_ids.input_ids, np.asarray(j_ids.input_ids))
    np.testing.assert_array_equal(p_w, j_w)
    assert p_w.dtype == np.float32 and p_w.max() > 1.0 and p_w.min() < 1.0


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("num_chunks", [None, 1, 4])
def test_tokenize_chunked_equal_jax(models, weighted, num_chunks):
    """A mixed batch (short, 2-chunk and 3-chunk prompts): every row is padded
    to the batch's K; ``num_chunks`` pins K below the need (truncating) and
    above it (EOS-only chunks)."""
    jax_model, port_model = models
    jte, pte = jax_model.text_encoder, port_model.text_encoder
    batch = ["a (red:1.5) cat", LONG, WEIGHTED_LONG]
    p_ids, p_w, p_k = pte.tokenize_chunked(batch, weighted=weighted, num_chunks=num_chunks)
    j_ids, j_w, j_k = jte.tokenize_chunked(batch, weighted=weighted, num_chunks=num_chunks)
    assert p_k == j_k == (num_chunks or 3)
    assert p_ids.shape == (3, p_k, 77)
    np.testing.assert_array_equal(p_ids, j_ids)
    if weighted:
        np.testing.assert_array_equal(p_w, j_w)
    else:
        assert p_w is None and j_w is None


@pytest.mark.parametrize("prompts", [
    ["a (red:1.5) cat", "((an astronaut)) riding a [horse]"],   # weighted, one chunk
    [LONG, "a short one"],                                      # long: [2, 154, 32]
    [WEIGHTED_LONG, "(short:1.2)"],                              # weighted and long: [2, 231, 32]
], ids=["weighted", "long", "weighted_long"])
def test_encode_prompts_weighted_and_long_match_jax(models, prompts):
    jax_model, port_model = models
    ref = np.asarray(jax_model.encode_prompts(prompts))
    out = port_model.encode_prompts(prompts)
    assert out.shape == ref.shape and ref.shape[1] % 77 == 0
    np.testing.assert_allclose(out.numpy(), ref, **EMB)


def test_negative_prompt_is_weighted_and_chunked_as_jax(models):
    """``encode_uncond`` goes through ``encode_prompts``: a weighted negative
    prompt, and a long one aligned (tiled) to a shorter context."""
    jax_model, port_model = models
    for negative in ["(blurry:1.6), [[low quality]]", LONG]:
        ref = np.asarray(jax_model.encode_uncond(2, negative))
        out = port_model.encode_uncond(2, negative)
        np.testing.assert_allclose(out.numpy(), ref, **EMB)
    ctx = port_model.encode_prompts([WEIGHTED_LONG])
    aligned = port_model.align_uncond(port_model.encode_uncond(1, "(blurry:1.6)"), ctx)
    ref = jax_model.align_uncond(jax_model.encode_uncond(1, "(blurry:1.6)"), jax_model.encode_prompts([WEIGHTED_LONG]))
    assert aligned.shape == (1, 231, 32)
    np.testing.assert_allclose(aligned.numpy(), np.asarray(ref), **EMB)


def test_reference_compat_keeps_brackets_literal_and_truncates(models):
    jax_model, port_model = models
    saved = jax_model.compat, port_model.compat
    try:
        jax_model.compat = port_model.compat = type("Compat", (), {"reference_compat": True})()
        for prompts in (["a (red:1.5) cat"], [WEIGHTED_LONG]):
            ref = np.asarray(jax_model.encode_prompts(prompts))
            out = port_model.encode_prompts(prompts)
            assert out.shape == ref.shape == (1, 77, 32)
            np.testing.assert_allclose(out.numpy(), ref, **EMB)
    finally:
        jax_model.compat, port_model.compat = saved


def test_token_weights_rescale_to_the_original_mean(models):
    """The weighted embedding keeps the unweighted one's abs-mean (f32)."""
    _, port_model = models
    pte = port_model.text_encoder
    ids, w = pte.tokenize_weighted(["a (red:1.5) [cat]"])
    plain = pte.encode_text(ids.input_ids)
    weighted = pte.encode_text(ids.input_ids, token_weights=w)
    assert torch.allclose(weighted.abs().mean(), plain.abs().mean(), rtol=1e-5)
    assert not torch.allclose(weighted, plain)


def _ti_vectors(k: int, d: int = 32):
    return np.random.default_rng(5).standard_normal((k, d)).astype(np.float32)


@pytest.fixture
def with_ti(models):
    """Both facades with the same concept registered; unregistered after."""
    jax_model, port_model = models
    jte, pte = jax_model.text_encoder, port_model.text_encoder
    jte._encode_ti = jax.jit(lambda p, ids, ov_ids, ov_vec: jte.module.apply(p, ids, token_overrides=(ov_ids, ov_vec)))
    yield jax_model, port_model
    jte._ti = pte._ti = None


def test_textual_inversion_matches_jax(with_ti):
    """The placeholder twice in a prompt (and inside a weighted fragment):
    sentinel ids equal, embeddings at 1e-4."""
    jax_model, port_model = with_ti
    vec = _ti_vectors(3)
    j_ids = jax_model.text_encoder.add_textual_inversion("<cat-toy>", vec)
    p_ids = port_model.text_encoder.add_textual_inversion("<cat-toy>", vec)
    np.testing.assert_array_equal(p_ids, j_ids)
    prompts = ["a photo of <cat-toy> next to <cat-toy>", "a ((<cat-toy>)) on a beach"]
    tok_p = port_model.text_encoder.tokenize(prompts).input_ids
    np.testing.assert_array_equal(tok_p, np.asarray(jax_model.text_encoder.tokenize(prompts).input_ids))
    assert (tok_p[0] >= 49408).sum() == 6
    ref = np.asarray(jax_model.text_encoder.encode_text(tok_p))
    out = port_model.text_encoder.encode_text(tok_p)
    np.testing.assert_allclose(out.numpy(), ref, **EMB)
    np.testing.assert_allclose(port_model.encode_prompts(prompts).numpy(),
                               np.asarray(jax_model.encode_prompts(prompts)), **EMB)


def test_textual_inversion_loads_the_port_checkpoint_layout(with_ti, tmp_path):
    """``train_state.pt`` with ``params = {"ti": [K, D]}`` plus the JAX
    sidecar, resolved to the newest ``checkpoint-N`` as JAX resolves it."""
    jax_model, port_model = with_ti
    vec = _ti_vectors(2)
    save_checkpoint(str(tmp_path / "checkpoint-4"), {"step": 4, "params": {"ti": torch.from_numpy(vec)},
                                                     "ema_params": None})
    (tmp_path / "textual_inversion.json").write_text(json.dumps({"placeholder_token": "<sks>", "num_vectors": 2}))
    assert port_model.text_encoder.load_textual_inversion(str(tmp_path)) == "<sks>"
    jax_model.text_encoder.add_textual_inversion("<sks>", vec)
    prompt = ["<sks> in the style of <sks>"]
    np.testing.assert_allclose(port_model.encode_prompts(prompt).numpy(),
                               np.asarray(jax_model.encode_prompts(prompt)), **EMB)
    (tmp_path / "textual_inversion.json").write_text(json.dumps({"placeholder_token": "<sks>", "num_vectors": 3}))
    with pytest.raises(ValueError, match="3 vectors"):
        port_model.text_encoder.load_textual_inversion(str(tmp_path))


def test_encode_text_static_inputs_match_jax(with_ti):
    """The tower's inputs as its CUDA graph takes them: the ids one tensor
    on the tower's device (a tensor taken as given), the concept's ids and
    vectors from the tensors held beside the tower, which
    ``set_textual_inversion_vectors`` updates in place. Without and with a
    concept, without and with token weights: JAX's ``encode_text`` at 1e-4.
    On the CPU nothing is captured."""
    jax_model, port_model = with_ti
    jte, pte = jax_model.text_encoder, port_model.text_encoder
    prompts = ["a (red:1.5) photo of <c>", "<c> on a [beach]"]

    def check():
        ids, w = pte.tokenize_weighted(prompts)
        np.testing.assert_array_equal(ids.input_ids, np.asarray(jte.tokenize_weighted(prompts)[0].input_ids))
        for weights in (None, w):
            ref = np.asarray(jte.encode_text(ids.input_ids, token_weights=weights))
            out = pte.encode_text(torch.as_tensor(ids.input_ids), token_weights=weights)
            np.testing.assert_allclose(out.numpy(), ref, **EMB)

    check()
    vec = _ti_vectors(2)
    jte.add_textual_inversion("<c>", vec)
    pte.add_textual_inversion("<c>", vec)
    check()
    held = pte._ti_device[2]
    np.testing.assert_array_equal(held.numpy(), vec)
    jte.set_textual_inversion_vectors(2 * vec)
    pte.set_textual_inversion_vectors(2 * vec)
    assert pte._ti_device[2] is held
    np.testing.assert_array_equal(held.numpy(), 2 * vec)
    check()
    assert not pte._graphs.graphs
