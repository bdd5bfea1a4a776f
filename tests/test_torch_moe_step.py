"""An EDITOR with the MoE joint MLP (``MODEL.MOE_EXPERTS`` = 4) against the
JAX package's, on the CPU at float64 with JAX x64 on (``tests/torch_dp_jax.py``'s
tiny config and batch, drop path 0): two train steps on one device and the
global-batch step at data 2 (gloo ranks, ``tests/torch_dp.py``) against JAX's
``build_train_step`` on a mesh of 1 and 2 devices. The data mesh routes the
global batch: the slots, the capacity and the aux loss's means are the
global batch's, as JAX's.

Tolerances: the losses at ``test_torch_dp_step.py``'s rtol 1e-7; each
parameter's change within 2e-6 of that tensor's largest change (or atol
1e-15), where ``test_torch_dp_step.py`` holds 1e-7: both packages run the
experts in fp32 whatever the model's type (JAX casts to fp32; the port
follows), so the two fp32 products, summed in different orders, move every
parameter downstream of the MoE by up to ~6e-7 of its change. The BN
running stats within 1e-6 relative or 1e-7 absolute (1e-7 and 1e-8 there:
the fused head's batch statistics of the MoE's fp32 output move by up to
~5e-8 in entries of ~0.5), the OCFR centers as there.
"""

import pytest

from tests.torch_dp import finish, start_ranks
from tests.torch_dp_jax import (close_to_jax, jax_global, jax_setup, jax_state_dict,
                                make_batch, port_inputs)
from tests.torch_parity import x64  # noqa: F401


@pytest.mark.parametrize("W", [1, 2])
def test_moe_editor_train_step_matches_jax(x64, W, tmp_path):
    jcfg, _, _, state = jax_setup(moe_experts=4)
    batch = make_batch()
    inp = port_inputs(jcfg, state, batch)
    assert any(k.startswith("FUSE_block.moe_mlp.") for k in inp["sd"])
    launch = start_ranks("train", W, tmp_path, dict(inp, runs=[
        {"kind": "single" if W == 1 else "global"}]))
    ref_losses, ref_state = jax_global(state, batch, W, moe_experts=4)
    got = finish(launch, timeout=120)
    assert close_to_jax(got[0][0], ref_losses, jax_state_dict(jcfg, ref_state), inp["sd"],
                        param_tol=2e-6, stat_tol=(1e-6, 1e-7))
