"""PyTorch port vs the JAX package: the sine scroller (ROADMAP A14).

The port takes the w + h sines in float64 and rounds them once to
float32 (rustexp_tpu_torch/sims/sine.py), so its frame does not depend on
a device's sinf; held here against JAX's sine_frame at 0 differing
pixels (measured: 0 at every tick below).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rustexp_tpu.sims.sine import SineExperiment as JaxSine
from rustexp_tpu.sims.sine import sine_frame as jax_sine_frame
from rustexp_tpu_torch.sims.sine import SineExperiment, sine_frame

CPU = torch.device("cpu")


def _bits(fb: torch.Tensor) -> np.ndarray:
    assert fb.dtype == torch.uint32
    return fb.view(torch.int32).numpy().view(np.uint32)


@pytest.mark.parametrize("tick", [0.0, 0.37, 1.0 / 60.0, 0.5, 7.3, 1234.5678])
def test_sine_frame_matches_jax_512(tick):
    want = np.asarray(jax_sine_frame(jnp.arange(512, dtype=jnp.float32),
                                     jnp.arange(512, dtype=jnp.float32),
                                     tick))
    got = _bits(sine_frame(512, 512, tick, CPU))
    assert np.array_equal(got, want)


def test_experiment_matches_jax_over_steps():
    """The tick is a Python float that step accumulates and render rounds
    to float32; 90 steps of both experiments give the same frames at a
    non-square size."""
    je, te = JaxSine(), SineExperiment(CPU)
    js, ts = je.init(), te.init()
    for i in range(90):
        js, ts = je.step(js), te.step(ts)
        assert ts.tick == js.tick
        if i % 30 == 29:
            want = np.asarray(je.render(js, 96, 40))
            assert np.array_equal(_bits(te.render(ts, 96, 40)), want)
    assert te.handle_key(ts, "x") is ts
    assert te.status(ts).endswith("ms")


def test_experiment_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SineExperiment()
    assert SineExperiment("cpu").device == CPU
