"""The reference example's own model on the port: ``llama_pretrain --hidden H
--vocab V`` builds ``LlamaLM(vocab V, hidden H, layers, heads 4, dff 3H)``
as ``examples/jax_llama_pretrain.py`` does, whose head dim at ``--hidden
1024`` is 256 and at ``--hidden 2048`` 512.  One layer of it at vocab 64,
T 64, flash attention on both sides, the weights carried across by
``interop.jax_weights``: the loss and every gradient against the JAX
package.  Then the entry point end to end on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from bluefog_tpu.kernels import make_flash_attention_fn as jax_flash_fn
from bluefog_tpu.models.transformer import LlamaLM as JaxLlama
from bluefog_tpu_torch.examples import llama_pretrain
from bluefog_tpu_torch.interop.jax_weights import llama_state_dict
from bluefog_tpu_torch.kernels import make_flash_attention_fn
from bluefog_tpu_torch.models.transformer import LlamaLM

torch.set_num_threads(1)
HIDDEN, LAYERS, VOCAB, T = 1024, 1, 64, 64
# the reference example's widths (examples/jax_llama_pretrain.py:104-108)
CFG = dict(vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=LAYERS, num_heads=4,
           dff=3 * HIDDEN)
GRAD_REL = 1e-4  # f32 on both sides: max |diff| against max |grad| of each leaf


def _args(*extra):
    return llama_pretrain._parser().parse_args(list(extra))


def test_hidden_flag_builds_the_reference_example_model():
    cfg = llama_pretrain.model_config(_args("--hidden", "1024", "--vocab", "32000",
                                            "--layers", "12"))
    assert (cfg["hidden"], cfg["heads"], cfg["dff"], cfg["vocab"]) == (1024, 4, 3072, 32000)
    assert cfg["hidden"] // cfg["heads"] == 256
    # without --hidden the preset's widths stand, --vocab alone replaces its vocabulary
    assert llama_pretrain.model_config(_args("--vocab", "64")) == {
        **llama_pretrain.PRESETS["small"], "vocab": 64}


def test_reference_model_at_hidden_1024_matches_the_jax_package():
    _held_to_the_jax_package(HIDDEN)


def test_reference_model_at_hidden_2048_matches_the_jax_package():
    """``--hidden 2048``: D = 512, above 256, where the card runs the wide
    flash kernels."""
    _held_to_the_jax_package(2048)


def _held_to_the_jax_package(hidden):
    cfg = dict(CFG, hidden_size=hidden, dff=3 * hidden)
    ids = np.random.default_rng(0).integers(0, VOCAB, size=(2, T))
    jmodel = JaxLlama(**cfg, dtype=jnp.float32,
                      attention_fn=jax_flash_fn(block_q=32, block_k=32, interpret=True))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, T), jnp.int32))["params"]

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(ids))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1], jnp.asarray(ids)[:, 1:]).mean()

    want_loss, want_grads = jax.value_and_grad(loss_fn)(params)
    model = LlamaLM(**cfg, dtype=torch.float32, device="cpu",
                    attention_fn=make_flash_attention_fn())
    model.load_state_dict(llama_state_dict(jax.tree_util.tree_map(np.asarray, params), LAYERS))
    t_ids = torch.from_numpy(ids)
    loss = model(t_ids, labels=t_ids)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = llama_state_dict(jax.tree_util.tree_map(np.asarray, want_grads), LAYERS)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(want)
    for name, g in grads.items():
        ref = want[name]
        err = (g - ref).abs().max().item()
        assert err <= GRAD_REL * ref.abs().max().item(), (name, err)


def test_example_trains_the_reference_model_on_the_cpu():
    """``--hidden 256 --vocab 64`` end to end at the tiny preset's depth and
    sequence, the plain attention versions on the CPU."""
    out = llama_pretrain.run(_args("--preset", "tiny", "--device", "cpu", "--hidden", "256",
                                   "--vocab", "64", "--steps", "2"))
    assert (out["hidden"], out["heads"], out["head_dim"], out["vocab"]) == (256, 4, 64, 64)
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"][-1]))
    assert out["flash_launches"] == {"fwd": 0, "dkv": 0, "dq": 0}  # no kernel on the CPU
