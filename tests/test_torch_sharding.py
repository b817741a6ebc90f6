"""The port's multi-GPU layer (``parallel/sharding.py`` over
``parallel/distributed.py``) in gloo groups of CPU processes: two ranks
here (the meshes tile 2 x sample 1, by ``make_mesh``, and tile 1 x sample
2), four in ``test_torch_sharding4.py``.

On every mesh, every rank returns the same result, and:

- the sharded path (dense, and with ``use_bvh=True``), light-tracing and
  BDPT images equal the port's single-device images (rtol 2e-5) and the
  stored JAX renders of the same case (``assert_at_bar``);
- the sharded loss and gradients (``image_loss_and_grad_sharded``) equal
  the single-device ``grad.image_loss_and_grad``'s, within 1e-5 of each
  leaf's largest magnitude, and one ``train_step_sharded`` equals the
  single-device SGD update.

The ranks are spawned processes (``tests/torch_shard_worker.py``), one
torch thread each."""
import numpy as np
import pytest

import torch_shard_worker as W
from torch_port_util import (INTEGRATOR_REFS, REF_PATH, REF_SEED, REF_SIZE,
                             assert_at_bar)

# the stored JAX render of each rendering case that has one
STORED = {"path": lambda: np.load(REF_PATH),
          "light": lambda: np.load(INTEGRATOR_REFS["lt-box"])["image"],
          "bdpt": lambda: np.load(INTEGRATOR_REFS["bdpt-box"])["image"]}
MESHES = {"make_mesh": (2, 1), "1x2": (1, 2)}


def test_cases_are_the_stored_renders_cases():
    import json
    assert W.SIZE == REF_SIZE and W.SEED == REF_SEED
    for case, name in (("light", "lt-box"), ("bdpt", "bdpt-box")):
        stored = json.loads(str(np.load(INTEGRATOR_REFS[name])["case"]))
        assert stored["options"] == W.CASES[case][0]
        assert stored["seed"] == W.SEED and stored["size"] == list(W.SIZE)


def check_case(results, kind: str, case: str, single: dict):
    """Every rank's ``case`` on mesh ``kind`` against the single-device
    result (and the stored JAX render)."""
    keys = sorted(single)
    for r, got in enumerate(results):
        for key in keys:
            np.testing.assert_array_equal(
                got[f"{kind}/{case}/{key}"],
                results[0][f"{kind}/{case}/{key}"], err_msg=f"rank {r}")
    got = {k: results[0][f"{kind}/{case}/{k}"] for k in keys}
    if case != "train":
        np.testing.assert_allclose(got["image"], single["image"], rtol=2e-5,
                                   atol=2e-6)
        if case in STORED:
            assert_at_bar(got["image"], STORED[case]())
        return
    np.testing.assert_allclose(got["loss"], single["loss"], rtol=1e-5)
    np.testing.assert_array_equal(
        results[0][f"{kind}/train/step_loss"], got["loss"])
    for i in range(8):
        scale = np.abs(single[f"grad{i}"]).max()
        np.testing.assert_allclose(got[f"grad{i}"], single[f"grad{i}"],
                                   rtol=0, atol=1e-5 * scale,
                                   err_msg=f"grad{i}")
        # the step: w - lr * g, up to the subtraction's rounding
        np.testing.assert_allclose(got[f"new{i}"], single[f"new{i}"],
                                   rtol=1e-6, atol=W.LR * 1e-5 * scale,
                                   err_msg=f"new{i}")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return W.spawn(2, MESHES, str(tmp_path_factory.mktemp("ranks2")))


@pytest.fixture(scope="module")
def single():
    return {case: W.single_device(case) for case in W.CASES}


@pytest.mark.parametrize("kind", list(MESHES))
def test_mesh_shapes(results, kind):
    for got in results:
        assert tuple(got[f"{kind}/shape"]) == MESHES[kind]
        assert str(got[f"{kind}/axes"]) == "tile,sample"


@pytest.mark.parametrize("case", list(W.CASES))
@pytest.mark.parametrize("kind", list(MESHES))
def test_sharded_equals_single_device(results, single, kind, case):
    check_case(results, kind, case, single[case])
