"""Three ``make_train_step`` updates with two microbatches
(``train.accum_steps=2``: rows 0 and 1 of each batch, gradients averaged)
under AdamW with decoupled decay, warmup, clipping, a backbone factor and a
frozen subtree, in the PyTorch port against the JAX package's jitted step,
on the CPU (``run_both`` of ``test_torch_train_step.py``).

Tolerances (f32): each step's averaged loss within ``1e-5`` relative and
its gradient norm within ``1e-4``; each parameter's change over the three
updates within ``1e-2`` of its norm. Adam divides each gradient element by
its own running magnitude, so an element whose gradient is within rounding
of zero moves by up to the learning rate either way on either side (a few
elements of ``level_embed`` here, 1e-5 apart). Parameters whose whole
gradient is zero in exact arithmetic are left out, and counted: the biases
that the tiny model's one-channel group norms remove and the
self-attention key biases that a softmax ignores. The frozen subtree stays
bit-identical.
"""

import numpy as np
import torch

from tests.test_torch_train_step import assert_metrics_equal, run_both


def test_three_adamw_steps_with_two_microbatches_equal_jax():
    ref, out, (init, ref_params, _), state = run_both(
        optimizer="adamw", learning_rate=1e-3, weight_decay=1e-4,
        warmup_steps=2, grad_clip_norm=0.1, backbone_lr_factor=0.1,
        accum_steps=2, freeze=("dec1/ffn",))
    assert_metrics_equal(ref, out)
    grads = {k: p.grad for k, p in state.params.items() if p.grad is not None}
    floor = 1e-6 * float(torch.stack([g.norm() for g in grads.values()]).norm())
    noise = {k for k, g in grads.items() if float(g.norm()) <= floor}
    assert noise == ({f"dec{i}.self_attn.key.bias" for i in range(2)}
                     | {f"backbone.Conv_{i}.bias" for i in range(5)}
                     | {f"input_proj{i}.bias" for i in range(3)}
                     | {"extra_proj0.bias"})
    for name, p in state.params.items():
        if name.startswith("dec1.ffn."):  # frozen
            assert name not in grads and torch.equal(p, init[name])
            continue
        if name in noise:
            continue
        moved = np.linalg.norm(ref_params[name].numpy() - init[name].numpy())
        err = np.linalg.norm(p.detach().numpy() - ref_params[name].numpy())
        assert err <= 1e-2 * moved and moved > 0, (name, err, moved)
