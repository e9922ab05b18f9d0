"""EM checkpoint/resume.

The reference's only persistence is pickling the model object (dropping jit
closures, reference core.py:757-767) plus periodic in-memory snapshots
(``save_every``).  The equivalent here (SURVEY.md §5): durable
on-disk checkpoints of ``(params, opt_state, log_posterior, rng, step)``
per EM iteration, orbax-backed with a numpy ``.npz`` fallback, and a
``fit_em(..., checkpoint_dir=, checkpoint_every=, resume=)`` integration on
every model class.
"""

from __future__ import annotations

import os
import pickle

import jax
import numpy as np

__all__ = ["EMCheckpointer"]


class EMCheckpointer:
    """Step-indexed checkpoint store for EM state pytrees.

    Backed by pickled-numpy files by default (exact pytree-structure
    round-trip, which matters for the optax opt_state NamedTuples); pass
    ``use_orbax=True`` for orbax PyTree checkpointing of large array trees.
    State layout is a plain dict of arrays/pytrees: ``{"step", "params",
    "opt_state", "log_posterior", "rng"}`` (opt_state may be None for
    analytic M-steps).
    """

    def __init__(self, directory, use_orbax=False):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._ocp = None
        if use_orbax:
            try:  # pragma: no cover - environment dependent
                import orbax.checkpoint as ocp

                self._ocp = ocp
            except ImportError:
                pass

    # ------------------------------------------------------------------
    def _step_path(self, step):
        return os.path.join(self.directory, f"step_{step:08d}")

    def save(self, step, state):
        """Persist one EM step's state (host-synced)."""
        state = jax.tree.map(
            lambda x: np.asarray(x) if hasattr(x, "shape") else x, state
        )
        path = self._step_path(step)
        if self._ocp is not None:
            with self._ocp.PyTreeCheckpointer() as ckptr:
                ckptr.save(path, state, force=True)
        else:
            os.makedirs(path, exist_ok=True)
            with open(os.path.join(path, "state.pkl"), "wb") as f:
                pickle.dump(state, f)

    def restore(self, step=None, template=None):
        """Restore a step (default: latest).  Returns None if empty.

        ``template``: optional pytree with the target structure — orbax
        stores arrays but not container types (optax NamedTuple opt_states
        come back as lists), so pass e.g. a freshly-initialized state dict
        to restore the exact structure.  The pickle backend round-trips
        structure natively and ignores ``template``."""
        if step is None:
            step = self.latest_step()
            if step is None:
                return None
        path = self._step_path(step)
        if self._ocp is not None and not os.path.exists(
            os.path.join(path, "state.pkl")
        ):
            with self._ocp.PyTreeCheckpointer() as ckptr:
                if template is not None:
                    import jax

                    flat = ckptr.restore(path)
                    leaves = jax.tree_util.tree_leaves(flat)
                    treedef = jax.tree_util.tree_structure(template)
                    return jax.tree_util.tree_unflatten(treedef, leaves)
                return ckptr.restore(path)
        with open(os.path.join(path, "state.pkl"), "rb") as f:
            return pickle.load(f)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self):
        if not os.path.isdir(self.directory):
            return []
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_"):
                try:
                    steps.append(int(name[5:]))
                except ValueError:
                    continue
        return sorted(steps)
