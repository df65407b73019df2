"""Test harness config: run everything on a virtual 8-device CPU mesh.

Must set env vars before jax is imported anywhere.  Tests that need a CUDA
GPU carry the ``gpu`` marker (registered in pyproject.toml) and request the
``gpu`` fixture, which skips them here; on a machine with a GPU they run
with ``DOPPEL_TEST_GPU=1 python -m pytest -m gpu tests/``.
"""

import os

if not os.environ.get("DOPPEL_TEST_GPU"):
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("PROJECT_DATA_PATH", "/tmp/doppel_test_data")

import pathlib  # noqa: E402

import pytest  # noqa: E402

os.makedirs(os.environ["PROJECT_DATA_PATH"], exist_ok=True)

EXAMPLE_DATASET_DIR = pathlib.Path("/root/reference/example_dataset")


@pytest.fixture(scope="session")
def example_data_dir(tmp_path_factory):
    """Decompress the example dataset once per session (if available)."""
    import gzip
    import shutil

    if not EXAMPLE_DATASET_DIR.exists():
        pytest.skip("example dataset not available")
    out = tmp_path_factory.mktemp("example_data")
    for gz in EXAMPLE_DATASET_DIR.glob("*.csv.gz"):
        with gzip.open(gz, "rb") as f_in, open(out / gz.name[:-3], "wb") as f_out:
            shutil.copyfileobj(f_in, f_out)
    return out


@pytest.fixture()
def gpu():
    """The first CUDA device; skips the test where JAX has none (decided at
    run time, never at import, so every worker collects the same tests)."""
    import jax

    devices = [d for d in jax.devices() if d.platform == "gpu"]
    if not devices:
        pytest.skip("needs a CUDA GPU (compiled Pallas-Triton kernels)")
    return devices[0]


@pytest.fixture()
def small_config(tmp_path):
    """A Config with tiny blocking knobs suitable for CPU tests."""
    from doppelspeller.config import Config

    return Config(
        data_path=str(tmp_path),
        title_block=128,
        query_block=8,
        pair_block=64,
        score_dtype="float32",
    )


@pytest.fixture(scope="session")
def world(tmp_path_factory):
    """A synthetic truth DB + train + test set with known ground truth.

    Session-scoped: test_pipeline / test_round3_fixes / test_round4_fixes all
    consume it (module scope ran the ~19 s setup once per module)."""
    import random
    import string

    import numpy as np

    from doppelspeller.config import Config
    from doppelspeller.utils.io import TitleSet
    from doppelspeller.utils.misspell import generate_misspelled_name

    def _word(rng, n):
        return "".join(rng.choice(string.ascii_lowercase) for _ in range(n))

    rng = random.Random(11)
    tmp = tmp_path_factory.mktemp("world")
    cfg = Config(
        data_path=str(tmp),
        title_block=128,
        query_block=8,
        score_dtype="float32",
        pair_block=128,
        top_n_predicting=20,
        top_n_training=5,
        gbt_num_boost_round=40,
        gbt_early_stopping_rounds=40,
        seed=5,
    )
    truth_titles = []
    for _ in range(250):
        n_words = rng.randint(2, 4)
        truth_titles.append(
            " ".join(_word(rng, rng.randint(3, 9)) for _ in range(n_words))
        )
    truth = TitleSet.from_titles(
        truth_titles, ids=np.arange(1000, 1000 + len(truth_titles)), config=cfg
    )

    # train rows: 60 misspelled truth titles (labels known) + 30 random (label -1)
    train_titles, train_labels = [], []
    for i in range(60):
        t = truth.transformed[i]
        train_titles.append(generate_misspelled_name(t, rng))
        train_labels.append(int(truth.ids[i]))
    for _ in range(30):
        train_titles.append(" ".join(_word(rng, rng.randint(4, 8)) for _ in range(3)))
        train_labels.append(-1)
    train = TitleSet.from_titles(
        train_titles, ids=np.arange(len(train_titles)),
        labels=np.array(train_labels), config=cfg,
    )

    # test rows: 30 exact + 40 misspelled + 20 not-in-truth
    test_titles, actuals = [], []
    for i in range(100, 130):
        test_titles.append(truth.titles[i])
        actuals.append(int(truth.ids[i]))
    for i in range(130, 170):
        test_titles.append(generate_misspelled_name(truth.transformed[i], rng))
        actuals.append(int(truth.ids[i]))
    for _ in range(20):
        test_titles.append(" ".join(_word(rng, rng.randint(5, 9)) for _ in range(3)))
        actuals.append(-1)
    test = TitleSet.from_titles(
        test_titles, ids=np.arange(len(test_titles)), config=cfg
    )
    return cfg, truth, train, test, np.array(actuals)


@pytest.fixture(scope="session")
def trained(world):
    from doppelspeller.models.gbt import GBTParams
    from doppelspeller.models.trainer import train_model

    cfg, truth, train, test, actuals = world
    params = GBTParams.from_config(cfg)
    params.num_boost_round = 40
    model, report = train_model(
        config=cfg, train=train, truth=truth, params=params, save=True
    )
    return model, report
