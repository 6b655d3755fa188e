"""Shared access to the JAX reference for the port's parity tests.

`jax_ref` imports ``lightgbm_tpu`` for a test module. Under jax 0.9 that
import fails inside ``lightgbm_tpu/ops/split.py:_register_barrier_batching``,
whose ``optimization_barrier_p not in batching.primitive_batchers`` meets a
``PrimitiveBatchersProxy`` that has no ``__contains__``. The fixture gives
the proxy one (looking the primitive up in
``batching.fancy_primitive_batchers``) before importing the package, and
only when it is missing. It does so inside the fixture, never at import of
this file, and undoes it all at teardown: the ``__contains__`` it added
goes, every ``lightgbm_tpu`` module it imported leaves ``sys.modules``, and
the ``lightgbm_tpu`` modules that were loaded before it get their
namespaces back as they were. So the JAX package's own tests see the same
interpreter whether or not one of the port's tests ran before them in
their worker.

Other test files use the fixture with ``from tests.test_torch_ref import
jax_ref  # noqa: F401``.

Importing this file also pins PyTorch's intra-op threads to this process's
share of the machine's cores: every pytest-xdist worker collects every
test file, so each worker imports it, and six workers each running
PyTorch's default of one thread a core would put six threads on every core
(a case that takes 3 s alone took 500-780 s). One process without xdist
keeps a thread a core.
"""
import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(max(1, os.cpu_count()
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))


def _is_reference(name: str) -> bool:
    return name == "lightgbm_tpu" or name.startswith("lightgbm_tpu.")


@pytest.fixture(scope="module")
def jax_ref():
    """The ``lightgbm_tpu`` package, importable on this jax."""
    from jax._src.interpreters import batching

    proxy = type(batching.primitive_batchers)
    added = (not hasattr(proxy, "__contains__")
             and hasattr(batching, "fancy_primitive_batchers"))
    if added:
        proxy.__contains__ = (
            lambda self, prim: prim in batching.fancy_primitive_batchers)
    loaded = {name: dict(vars(mod)) for name, mod in list(sys.modules.items())
              if _is_reference(name) and mod is not None}
    try:
        import lightgbm_tpu

        yield lightgbm_tpu
    finally:
        for name in [n for n in list(sys.modules)
                     if _is_reference(n) and n not in loaded]:
            del sys.modules[name]
        for name, namespace in loaded.items():
            mod = sys.modules.get(name)
            if mod is not None:
                vars(mod).clear()
                vars(mod).update(namespace)
        if added:
            del proxy.__contains__


def test_reference_imports_and_pallas_matches_fused(jax_ref):
    import jax.numpy as jnp

    from lightgbm_tpu.ops.predict import _predict_raw_fused, pack_ensemble
    from lightgbm_tpu.ops.predict_pallas import pallas_predict_raw
    from lightgbm_tpu.models.serialize import GBDTModel
    from lightgbm_tpu_torch.models.synthetic import make_rows, random_model

    text = random_model(np.random.RandomState(0), 6, 4, 15, num_class=2,
                        cat_features=(1,), objective="multiclassova num_class:2"
                        ).to_string()
    packed = pack_ensemble(GBDTModel.from_string(text).trees)
    X = jnp.asarray(make_rows(np.random.RandomState(1), 300, 6, (1,)))
    fused = np.asarray(_predict_raw_fused(packed, X, 2))
    pallas = np.asarray(pallas_predict_raw(packed, X, 2, tile_rows=128,
                                           interpret=True))
    np.testing.assert_array_equal(pallas, fused)
