"""The port's GPipe pipeline (``repro_torch.parallel.pp``) against the
sequential stack, on 4 gloo ranks of the CPU (``tests/_torch_dist_child.py``:
a file rendezvous under the test's directory, one torch thread a rank, a
time limit on the launch and on every collective), at the reference's
shapes (``tests/test_pp.py``: 4 stages, D 16, microbatches of 8, 6 of
them, ``tanh(x @ w)`` a stage).

The output on every rank and each stage weight's gradient of ``sum(o *
o)`` are held within 1e-5 of the port's sequential stack (torch autograd)
and of ``jax.grad`` of the reference's sequential stack; the bubble
fraction equals the reference's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist_child import launch
from repro.parallel.pp import bubble_fraction as r_bubble_fraction
from repro_torch.parallel.pp import bubble_fraction

S, D, MB, NM = 4, 16, 8, 6
TOL = 1e-5


@pytest.mark.parametrize("n_stages,n_micro", [(4, 4), (4, 16), (1, 8), (4, 6), (8, 3)])
def test_bubble_fraction_matches_reference(n_stages, n_micro):
    assert bubble_fraction(n_stages, n_micro) == r_bubble_fraction(n_stages, n_micro)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("pp")
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((S, D, D)) * 0.3).astype(np.float32)
    x = rng.standard_normal((NM, MB, D)).astype(np.float32)
    np.save(out / "pp_w.npy", w)
    np.save(out / "pp_x.npy", x)
    launch("pipeline", S, out)
    return out, w, x


def _sequential_torch(w, x):
    wt = torch.from_numpy(w).requires_grad_(True)
    h = torch.from_numpy(x)
    for s in range(S):
        h = torch.tanh(h @ wt[s])
    (g,) = torch.autograd.grad((h * h).sum(), [wt])
    return h.detach().numpy(), g.numpy()


def _sequential_reference(w, x):
    def stack(wq):
        h = jnp.asarray(x)
        for s in range(S):
            h = jnp.tanh(h @ wq[s])
        return h

    with jax.enable_x64(False):
        out = stack(jnp.asarray(w))
        g = jax.grad(lambda wq: jnp.sum(stack(wq) ** 2))(jnp.asarray(w))
    return np.asarray(out), np.asarray(g)


@pytest.mark.parametrize("against", ["port_sequential", "reference_sequential"])
def test_pipeline_output_and_gradient_match_the_sequential_stack(run, against):
    out, w, x = run
    want_o, want_g = (_sequential_torch if against == "port_sequential"
                      else _sequential_reference)(w, x)
    outs = [np.load(out / f"pp_out.r{r}.npy") for r in range(S)]
    for r in range(S):  # every rank holds the last stage's outputs
        assert np.array_equal(outs[r], outs[0])
        np.testing.assert_allclose(outs[r], want_o, rtol=0, atol=TOL)
    # each rank's gradient is its own stage's block
    grads = np.concatenate([np.load(out / f"pp_grad.r{r}.npy") for r in range(S)])
    assert grads.shape == w.shape
    np.testing.assert_allclose(grads, want_g, rtol=0, atol=TOL * float(np.abs(want_g).max()))
    assert np.all(np.abs(grads).max(axis=(1, 2)) > 0)  # every stage learns
