"""One train step of the flagship model at full width (feat_dim=256,
eeg_time=585, B=8) on the CPU, port against JAX: every parameter gradient
(rtol 1e-3, atol 1e-4) and the BatchNorm running stats after the step
(1e-5), with the tolerances and reasons of ``test_torch_port_train.py``."""

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)
from test_torch_port_train import check_gradients, check_running_stats, one_train_step


def test_full_width_train_step_matches_jax():
    port, outs, ref_outs, ref_grads, ref_stats = one_train_step(256, 585, 8)
    assert all(o.shape == r.shape for o, r in zip(outs, ref_outs))
    check_gradients(port, ref_grads)
    check_running_stats(port, ref_stats)
