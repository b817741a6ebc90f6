"""The port's multi-GPU layer in a gloo group of four CPU processes: the
mesh tile 2 x sample 2 (``make_mesh``) and the multi-host mesh host 2 x
tile 1 x sample 2 (``make_multihost_mesh(force_hosts=2)``), each held as
``test_torch_sharding.py`` holds the two-rank meshes."""
import pytest

import torch_shard_worker as W
from test_torch_sharding import check_case

MESHES = {"make_mesh": ((2, 2), "tile,sample"),
          "hosts": ((2, 1, 2), "host,tile,sample")}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return W.spawn(4, MESHES, str(tmp_path_factory.mktemp("ranks4")))


@pytest.fixture(scope="module")
def single():
    return {case: W.single_device(case) for case in W.CASES}


@pytest.mark.parametrize("kind", list(MESHES))
def test_mesh_shapes(results, kind):
    shape, axes = MESHES[kind]
    for got in results:
        assert tuple(got[f"{kind}/shape"]) == shape
        assert str(got[f"{kind}/axes"]) == axes


@pytest.mark.parametrize("case", list(W.CASES))
@pytest.mark.parametrize("kind", list(MESHES))
def test_sharded_equals_single_device(results, single, kind, case):
    check_case(results, kind, case, single[case])
