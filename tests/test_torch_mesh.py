"""The port's ('chain', 'data') mesh (parallel/mesh.py) on 8 spawned gloo
ranks against the JAX package's make_mesh on its 8 virtual CPU devices
(tests/test_parallel.py:12-16): the same shapes, the same rank (device)
layout, each rank's coordinate and groups; a mesh larger than the world
raises ValueError with the JAX package's message."""

import jax
import numpy as np
import pytest

from bayesdll_tpu.parallel import make_mesh as j_make_mesh
from bayesdll_tpu_torch.parallel import make_mesh
from tests import torch_dist

WORLD = 8
SHAPES = ((4, 2), (8, 1), (2, 2))


@pytest.fixture(scope="module")
def ranks():
    return torch_dist.shared("mesh", lambda: torch_dist.run_world(
        torch_dist.mesh_world, WORLD, SHAPES))


@pytest.mark.parametrize("shape", SHAPES)
def test_mesh_matches_jax(ranks, shape):
    jm = j_make_mesh(*shape)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    assert dict(jm.shape) == {"chain": shape[0], "data": shape[1]}
    need = shape[0] * shape[1]
    for rank, out in enumerate(ranks):
        m = out[shape]
        assert m["names"] == ("chain", "data")
        assert m["shape"] == shape
        assert m["mesh"] == ids.tolist()  # rank r where JAX puts device r
        if rank >= need:
            assert m["coord"] is None
            continue
        i, j = divmod(rank, shape[1])
        assert tuple(m["coord"]) == (i, j)
        assert m["groups"]["data"] == ids[i].tolist()
        assert m["groups"]["chain"] == ids[:, j].tolist()


def test_mesh_larger_than_the_world_raises(ranks):
    with pytest.raises(ValueError) as jerr:
        j_make_mesh(WORLD, 2, devices=jax.devices()[:WORLD])
    assert all(out["too_big"] == str(jerr.value) for out in ranks)


def test_mesh_without_a_process_group_raises():
    with pytest.raises(ValueError, match="need 2 devices for mesh"):
        make_mesh(2, 1)
