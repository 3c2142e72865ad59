"""What ``tests/torch_orbax_fixture.py``, ``tests/test_torch_orbax.py`` and
phase 37 of ``chip_smoke.py`` share of the committed orbax fixture
``tests/data/jax_orbax_2proc``: its synthetic tree, its configs' templating
and the records of its arrays.  It imports nothing of JAX or of the JAX
package, so that the card's run (which has neither) can import it;
``tests/test_torch_isolation.py`` holds it to that.
"""
from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np

#: ``tools/synthetic_tree.py``'s seeded tree that the fixture was trained
#: and tested on
TREE = {"splits": {"train": [2, 1], "valid": [1, 1], "test": [1, 1]}, "cycle": 12, "hr": 64,
        "scale": 4, "seed": 0}


def fill(config, **values):
    """``config`` with each ``{name}`` string replaced by ``values[name]``."""
    if isinstance(config, dict):
        return {k: fill(v, **values) for k, v in config.items()}
    if isinstance(config, list):
        return [fill(v, **values) for v in config]
    if isinstance(config, str) and config.startswith("{") and config.endswith("}"):
        return str(values[config[1:-1]])
    return config


def write_tree(root: Path) -> dict:
    """``TREE`` written under ``root`` by the port's ``tools/synthetic_tree.py``."""
    from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.tools.synthetic_tree import (
        write_acdc_tree,
    )

    splits = {k: tuple(v) for k, v in TREE["splits"].items()}
    return write_acdc_tree(root, splits, cycle=TREE["cycle"], hr=TREE["hr"],
                           scale=TREE["scale"], seed=TREE["seed"])


def leaves(tree, prefix=()):
    """(key path, array) of every array of a restored tree, in key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, prefix + (str(i),))
    elif tree is not None:
        yield "/".join(prefix), tree


def array_record(array) -> dict:
    """An array's shape, dtype and the sha256 of its C-order bytes."""
    array = np.asarray(array)
    return {"shape": list(array.shape), "dtype": str(array.dtype),
            "sha256": hashlib.sha256(array.tobytes(order="C")).hexdigest()}
