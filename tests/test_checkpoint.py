"""Checkpoint files of the inverse-rendering fit (rayz_tpu.diff.checkpoint):
an .npz of the state pytree's leaves, restored into a template."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from rayz_tpu.diff.checkpoint import (latest_step, restore_checkpoint,
                                      save_checkpoint)


def _state():
    params = {"tex_color": jnp.arange(6.0).reshape(2, 3),
              "sphere_radius": jnp.asarray([0.5, 100.0], jnp.float32)}
    opt_state = optax.adam(1e-2).init(params)
    return {"params": params, "opt_state": opt_state,
            "key": jax.random.PRNGKey(3), "step": 7}


def test_roundtrip_keeps_structure_values_and_dtypes(tmp_path):
    state = _state()
    path = save_checkpoint(str(tmp_path), 7, state)
    assert path.endswith("step_7.npz")
    back = restore_checkpoint(str(tmp_path), state)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(state))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(state)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_latest_step_ignores_other_files(tmp_path):
    assert latest_step(str(tmp_path / "missing")) is None
    save_checkpoint(str(tmp_path), 3, _state())
    save_checkpoint(str(tmp_path), 12, _state())
    (tmp_path / "step_99.npz.tmp").write_bytes(b"partial")
    (tmp_path / "notes.txt").write_text("x")
    assert latest_step(str(tmp_path)) == 12


def test_restore_rejects_a_different_structure(tmp_path):
    save_checkpoint(str(tmp_path), 1, _state())
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(str(tmp_path), {"only": jnp.zeros(3)})


def test_restore_without_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path), _state())
