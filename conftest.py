"""Test-session shim for the JAX reference package.

JAX 0.9 removed ``jax.experimental.enable_x64``, which the reference
(``src/repro``) imports.  Where the name is missing it is aliased to
``jax.enable_x64`` (same context-manager use).  The reference's tests
also start ``spawn`` process pools, whose fresh interpreters import the
reference before anything of pytest runs; they get the same alias by
running this file as their ``__main__`` (spawn's preparation step runs
it before unpickling the pool's work).  Nothing else changes.
"""
import multiprocessing.spawn

try:
    import jax
    import jax.experimental
except ImportError:         # a host without JAX runs only the port's tests
    jax = None

if jax is not None and not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64
    _preparation_data = multiprocessing.spawn.get_preparation_data

    def _prepare_with_alias(name):
        data = _preparation_data(name)
        data.pop("init_main_from_name", None)
        data["init_main_from_path"] = __file__
        return data

    multiprocessing.spawn.get_preparation_data = _prepare_with_alias
