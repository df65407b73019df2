"""doppelspeller — a JAX fuzzy-title matching framework.

Re-implements the capabilities of the reference `doppel-speller` project
(misspelled-title → best truth-title matching) as an accelerator program:

* a device-resident, bit-packed n-gram×title index scored with blocked
  matrix products fused with top-k selection (reference: numba
  `fast_jaccard` + scipy sparse, match_maker.py:16-203),
* a batched LCS/Levenshtein-ratio kernel computed as a vectorized
  cummax-scan DP over padded uint8 char tensors (reference: numba
  `fast_levenshtein_ratio`, feature_engineering.py:25-63),
* a vectorized 66-dim feature kernel (reference: numba `construct_features`,
  feature_engineering.py:66-169),
* a gradient-boosted-tree model trained on the device with the reference's
  custom weighted-log-loss objective and custom-error metric (reference:
  XGBoost, train.py:17-137), with tensorized device-side inference,
* a truth index sharded across a `jax.sharding.Mesh` with per-shard top-k
  merged by an all-gather (new capability; the reference is single-node).
"""

import os

__version__ = "0.1.0"
__build__ = "gpu"

module_name = "doppelspeller"

# the checkout's root: in-checkout caches (compiled programs, the native
# library) live under it, in directories .gitignore lists
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else the checkout's .jax_cache/
    (a fixed path: the cache key includes it, so a moving path never hits)."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(REPO_ROOT, ".jax_cache"))


def _enable_compilation_cache() -> None:
    """Persistent XLA compilation cache, so a later process reloads compiled
    programs instead of compiling them again."""
    import jax

    jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


_enable_compilation_cache()
