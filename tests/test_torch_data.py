"""The port's configurations equal the reference's, and its synthetic data
follows the reference recipe (shapes, split, sparse truth, labels) from
either source of random numbers, deterministically per seed."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import glm as jglm
from repro_torch.configs import glm as tglm
from repro_torch.configs.base import GLMConfig
from repro_torch.data.synthetic import make_glm_dataset

torch.set_num_threads(2)


@pytest.mark.parametrize("name", ["GLM_EPSILON", "GLM_WEBSPAM", "GLM_DNA"])
def test_configs_equal_the_reference(name):
    ref, got = getattr(jglm, name), getattr(tglm, name)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert dataclasses.asdict(tglm.twin(got, 0.01)) == dataclasses.asdict(jglm.twin(ref, 0.01))
    assert dataclasses.asdict(got.smoke()) == dataclasses.asdict(ref.smoke())
    assert set(tglm.GLM_CONFIGS) == set(jglm.GLM_CONFIGS)


@pytest.mark.parametrize("source", ["numpy", "torch"])
@pytest.mark.parametrize("density", [1.0, 0.2])
def test_synthetic_recipe(source, density):
    cfg = GLMConfig(name="t", num_examples=1000, num_features=60, density=density)

    def make():
        gen = (np.random.default_rng(3) if source == "numpy"
               else torch.Generator(device="cpu").manual_seed(3))
        return make_glm_dataset(cfg, gen, device="cpu")

    ds, again = make(), make()
    assert ds.X_train.shape == (800, 60) and ds.X_test.shape == (200, 60)
    assert ds.X_train.dtype == torch.float32 and ds.y_train.dtype == torch.float32
    assert torch.equal(ds.X_train, again.X_train) and torch.equal(ds.y_train, again.y_train)
    assert int((ds.beta_true != 0).sum()) == max(4, 60 // 20)
    assert set(ds.y_train.unique().tolist()) <= {-1.0, 1.0}
    share = ds.nnz / (1000 * 60)
    assert abs(share - density) < 0.05
    # labels follow the logistic model: where the true margin is not zero
    # (a sparse row may miss every informative feature), its sign predicts
    # the label well above chance (0.5 +- 0.02 over these rows; the truth's
    # small coefficients and the 5% flips keep it near 0.7-0.8)
    margin = ds.X_train @ ds.beta_true
    live = margin != 0
    acc = float((torch.sign(margin[live]) == ds.y_train[live]).float().mean())
    assert acc > 0.6


def test_unknown_generator_is_rejected():
    cfg = GLMConfig(name="t", num_examples=10, num_features=4)
    with pytest.raises(TypeError):
        make_glm_dataset(cfg, 3, device="cpu")
