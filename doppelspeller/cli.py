"""Command-line interface.

Reference parity (cli.py:14-132): the same verbs with the same verbosity
contract (-v/-vv/-vvv → WARNING/INFO/DEBUG), plus build-index
checkpointing, a persistent ``serve`` loop and ``--devices N`` meshes.

Run as ``python -m doppelspeller.cli`` or the ``doppel`` script.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from typing import List, Optional

from doppelspeller import __build__, __version__
from doppelspeller.utils.timing import time_usage

LOGGER = logging.getLogger(__name__)


class CliError(Exception):
    """A usage error reported as ``Error: ...`` with exit code 1."""


def _mesh(devices: int, platform: Optional[str], axis: str):
    if not devices:
        return None
    from doppelspeller.parallel.sharded import make_mesh

    return make_mesh(devices, axis=axis, platform=platform)


@time_usage
def stage_example_data_set(source: str) -> None:
    """Copy + decompress the example dataset into PROJECT_DATA_PATH."""
    import glob
    import gzip
    import shutil

    from doppelspeller.config import get_config

    cfg = get_config()
    os.makedirs(cfg.data_path, exist_ok=True)
    for gz in glob.glob(os.path.join(source, "*.csv.gz")):
        dest = os.path.join(cfg.data_path, os.path.basename(gz)[:-3])
        with gzip.open(gz, "rb") as f_in, open(dest, "wb") as f_out:
            shutil.copyfileobj(f_in, f_out)
        print(f"staged {dest}")


@time_usage
def build_index(devices: int, platform: Optional[str]) -> None:
    """Build and checkpoint the packed truth index (new capability)."""
    from doppelspeller.config import get_config
    from doppelspeller.ops.ngram_index import build_truth_index
    from doppelspeller.utils.io import load_ground_truth

    cfg = get_config()
    truth = load_ground_truth(cfg)
    mesh = _mesh(devices, platform, cfg.mesh_axis)
    if mesh is not None:
        from doppelspeller.parallel.sharded import build_sharded_index

        scorer = build_sharded_index(truth, mesh, cfg)
        scorer.save(cfg.index_path)
        index = scorer.index
    else:
        index = build_truth_index(truth, cfg)
        index.save(cfg.index_path)
    print(f"index saved to {cfg.index_path} "
          f"({index.num_titles} titles, {index.packed_nbytes / 1e6:.0f} MB packed)")


@time_usage
def train_model(devices: int, platform: Optional[str]) -> None:
    """Train the model."""
    from doppelspeller.config import get_config
    from doppelspeller.models.trainer import train_model as _train

    LOGGER.info("Training the model!")
    model, report = _train(mesh=_mesh(devices, platform, get_config().mesh_axis))
    em = report["error_matrix"]
    print(
        f"trees={model.num_trees} best={model.best_ntree_limit} "
        f"eval custom-error={report['eval_custom_error']:.0f} "
        f"TP={em['tp']} TN={em['tn']} FP={em['fp']} FN={em['fn']}"
    )
    # top feature importances (reference train.py:50-60,123)
    imp = report["feature_importance"]
    top = sorted(enumerate(imp), key=lambda kv: -kv[1])[:10]
    print("top features: " + ", ".join(f"f{i}={v:.3f}" for i, v in top))


@time_usage
def generate_predictions(devices: int, platform: Optional[str]) -> None:
    """Generate predictions for the test file."""
    from doppelspeller.config import get_config
    from doppelspeller.pipeline import Matcher
    from doppelspeller.utils.io import load_test_data

    cfg = get_config()
    LOGGER.info("Generating the predictions!")
    matcher = Matcher(cfg, mesh=_mesh(devices, platform, cfg.mesh_axis))
    result = matcher.predict(load_test_data(cfg))
    result.save_csv(cfg.final_output_path, cfg.delimiter)
    print(f"output saved to {cfg.final_output_path}")


@time_usage
def closest_search_single_title(title: str) -> None:
    """Closest match for a single title."""
    from doppelspeller.config import get_config
    from doppelspeller.pipeline import Matcher
    from doppelspeller.utils.io import single_title_set

    title = title.strip()
    if not title:
        raise CliError("empty --title-to-search")
    cfg = get_config()
    matcher = Matcher(cfg)
    result = matcher.predict(single_title_set(title, cfg), single=True)
    print(f"Closest match: {result.single_result()}")


def serve_config(cfg, profile: str):
    """The Config ``serve`` runs under.  'latency' retunes the cascade's
    static shapes for single/small requests: a single title pays an
    (8 × 128-union) retrieval product and one small rerank slab instead of
    the batch path's (128 × 1024) + 2048-slab machinery.  Same kernels and
    semantics — only the compiled shapes change.  'throughput' keeps the
    production batch shapes."""
    if profile == "latency":
        return cfg.with_(
            query_block=8,
            dispatch_blocks=1,
            union_buckets=(128, 256, 512, 1024, 2048, 4096, 8192),
            model_slab=128,
            rerank_chunk_cap=128,
        )
    if profile != "throughput":
        raise ValueError(f"unknown serve profile {profile!r}")
    return cfg


class Server:
    """The request handler behind ``serve``: one JSON-line request in, one
    JSON-serialisable response out, over one warm Matcher."""

    def __init__(self, matcher):
        self.matcher = matcher
        self.cfg = matcher.cfg

    def warmup(self) -> None:
        """Compile the single-title and batch cascades before serving."""
        import numpy as np

        from doppelspeller.utils.io import TitleSet, single_title_set

        m, cfg = self.matcher, self.cfg
        m.predict(single_title_set("wrmup exampl compani", cfg), single=True)
        # a longer title warms the next fuzzy-tile bucket of the fused
        # one-dispatch cascade (programs are keyed on the length bucket)
        m.predict(single_title_set(
            "wrmup exampl compani with a much longer title form", cfg,
        ), single=True)
        # the batch-cascade programs too (block-padded static shapes, so
        # any later batch size reuses them)
        m.predict(TitleSet.from_titles(
            ["wrmup alpha co", "wrmup bravo ltd", "wrmup carlo inc"],
            ids=np.arange(3, dtype=np.int64), config=cfg,
        ))

    def single(self, title: str, req_id=None) -> dict:
        from doppelspeller.utils.io import single_title_set

        t = time.time()
        res = self.matcher.predict(single_title_set(title, self.cfg), single=True)
        out = res.single_result()
        if req_id is not None:
            out["test_index"] = req_id
        out["title"] = title
        out["latency_ms"] = round((time.time() - t) * 1e3, 2)
        return out

    def batch(self, titles: List[str]) -> dict:
        import numpy as np

        from doppelspeller.utils.io import TitleSet

        t = time.time()
        qs = TitleSet.from_titles(
            list(titles), ids=np.arange(len(titles), dtype=np.int64),
            config=self.cfg,
        )
        res = self.matcher.predict(qs)
        return {
            "results": [
                {
                    "title": titles[i],
                    "transformed_title": res.transformed[i],
                    "match_title_id": int(res.match_title_id[i]),
                    "match_transformed_title": res.match_transformed[i],
                    "prediction": float(res.prediction[i]),
                }
                for i in range(len(titles))
            ],
            "latency_ms": round((time.time() - t) * 1e3, 2),
        }

    def handle(self, line: str) -> dict:
        """Answer one request line; a bad request yields {"error": ...}."""
        try:
            if not line.startswith("{"):
                return self.single(line)
            req = json.loads(line)
            if "titles" not in req:
                return self.single(str(req["title"]), req.get("id"))
            titles = req["titles"]
            # a bare string is iterable — without this check
            # {"titles": "acme co"} would match per CHARACTER
            if not isinstance(titles, list) or not all(
                isinstance(t, str) for t in titles
            ):
                return {"error": "'titles' must be a list of strings"}
            if not titles:
                return {"results": [], "latency_ms": 0.0}
            return self.batch(titles)
        except Exception as exc:  # serve loop must survive any bad request
            return {"error": f"{type(exc).__name__}: {exc}"}


def serve(warmup: bool, devices: int, platform: Optional[str],
          profile: str) -> None:
    """Persistent matching service over stdin/stdout (JSON lines).

    The engine — packed index, model trees, every cascade program — is
    built ONCE and stays warm on the device; each request ships only the
    query.  (The reference rebuilds its whole MatchMaker per single-title
    call, reference cli.py:64-83 / predict.py:286-289.)

    One request per input line::

      acme holdigns ltd                     bare title
      {"id": 7, "title": "acme holdigns"}   single title with caller id
      {"titles": ["a co", "b co"]}          small batch

    One JSON response per line.  Single-title requests return the argmax
    candidate regardless of threshold (reference single-title semantics,
    predict.py:316-317); batch requests apply full production semantics
    (0.9 threshold, −1 not-found).  Single and small requests run the fused
    one-dispatch cascade (retrieval → fuzzy → model in one device program,
    ops/serve_fused.py).  The first request whose candidates land in a new
    length bucket compiles its program once (cached persistently across
    processes).
    """
    from doppelspeller.config import get_config
    from doppelspeller.pipeline import Matcher

    cfg = serve_config(get_config(), profile)
    t0 = time.time()
    server = Server(Matcher(cfg, mesh=_mesh(devices, platform, cfg.mesh_axis)))
    if warmup:
        server.warmup()
    print(f"# ready: {server.matcher.index.num_titles} titles indexed, "
          f"engine warm in {time.time() - t0:.1f}s", file=sys.stderr, flush=True)
    for line in sys.stdin:
        line = line.strip()
        if line:
            print(json.dumps(server.handle(line)), flush=True)


@time_usage
def get_predictions_accuracy() -> None:
    """Print predictions accuracy vs the actuals file."""
    from doppelspeller.config import get_config
    from doppelspeller.pipeline import accuracy_report

    cfg = get_config()
    report = accuracy_report(cfg.test_with_actuals_path, cfg.final_output_path, cfg.delimiter)
    print(
        f"\nCorrectly matched titles            {report['correctly_matched']}\n"
        f"Incorrectly matched titles          {report['incorrectly_matched']}\n"
        f"Correctly marked as not-found       {report['correctly_not_found']}\n"
        f"Incorrectly marked as not-found     {report['incorrectly_not_found']}\n\n"
        f"Custom Error                        {report['custom_error']}"
    )


def _device_options(p: argparse.ArgumentParser, what: str) -> None:
    p.add_argument("--devices", type=int, default=0,
                   help=f"{what} 0 = single device.")
    p.add_argument("--platform", default=None,
                   help="Device platform for the mesh (e.g. 'cpu' to use "
                        "virtual CPU devices via "
                        "--xla_force_host_platform_device_count).")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="doppel", description=__doc__.split("\n")[0])
    parser.add_argument("--version", action="version", version=__version__)
    parser.add_argument(
        "-v", "--verbose", action="count", default=None,
        help="Make output more verbose. Use more v's for more verbosity "
             "(default: $LOGGING_LEVEL or 0).")
    sub = parser.add_subparsers(dest="command", metavar="COMMAND", required=True)

    p = sub.add_parser("stage-example-data-set",
                       help=stage_example_data_set.__doc__.split("\n")[0])
    p.add_argument("--source", default="/root/reference/example_dataset",
                   help="Directory containing the gzipped example dataset.")
    p.set_defaults(run=lambda a: stage_example_data_set(a.source))

    p = sub.add_parser("build-index", help=build_index.__doc__.split("\n")[0])
    _device_options(p, "Build the index sharded over an N-device mesh "
                       "(per-shard on-device build, shard-by-shard checkpoint "
                       "— no full matrix on the host or any single device).")
    p.set_defaults(run=lambda a: build_index(a.devices, a.platform))

    p = sub.add_parser("train-model", help=train_model.__doc__.split("\n")[0])
    _device_options(p, "Train on an N-device mesh: candidate retrieval over "
                       "the title-sharded index, boosting data-parallel over "
                       "samples with psum-ed histograms.")
    p.set_defaults(run=lambda a: train_model(a.devices, a.platform))

    p = sub.add_parser("generate-predictions",
                       help=generate_predictions.__doc__.split("\n")[0])
    _device_options(p, "Run on an N-device mesh: truth index sharded over "
                       "the title axis, fuzzy/model stages data-parallel "
                       "over rows.")
    p.set_defaults(run=lambda a: generate_predictions(a.devices, a.platform))

    p = sub.add_parser("closest-search-single-title",
                       help=closest_search_single_title.__doc__.split("\n")[0])
    p.add_argument("-t", "--title-to-search", dest="title", required=True)
    p.set_defaults(run=lambda a: closest_search_single_title(a.title))

    p = sub.add_parser("serve", help=serve.__doc__.split("\n")[0])
    p.add_argument("--warmup", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="Compile the single-title cascade before reading "
                        "input (default: on).")
    _device_options(p, "Serve from an N-device mesh: truth index sharded over "
                       "the title axis (for truth sets beyond one device's "
                       "memory).")
    p.add_argument("--profile", default="latency",
                   choices=["latency", "throughput"],
                   help=serve_config.__doc__.split("\n")[0] + " "
                        "(default: latency).")
    p.set_defaults(run=lambda a: serve(a.warmup, a.devices, a.platform,
                                       a.profile))

    p = sub.add_parser("get-predictions-accuracy",
                       help=get_predictions_accuracy.__doc__.split("\n")[0])
    p.set_defaults(run=lambda a: get_predictions_accuracy())
    return parser


def _configure_logging(verbose: int) -> None:
    if verbose <= 1:
        level = logging.WARNING
    elif verbose == 2:
        level = logging.INFO
    else:
        level = logging.DEBUG
    logging.basicConfig(
        stream=sys.stdout, level=level,
        format="[%(asctime)s]%(levelname)s|%(name)s|%(message)s",
    )
    # banner after basicConfig so it is actually emitted at -vv/-vvv
    LOGGER.info("doppelspeller v%s-%s", __version__, __build__)


def cli(argv: Optional[List[str]] = None) -> int:
    """Parse ``argv`` (default: sys.argv[1:]), run the command, and return
    the process exit code."""
    args = build_parser().parse_args(argv)
    verbose = args.verbose
    if verbose is None:
        verbose = int(os.environ.get("LOGGING_LEVEL", "0") or 0)
    _configure_logging(verbose)
    if os.environ.get("DOPPEL_DEBUG_NANS"):
        # NaN debugging for the functional kernels (SURVEY.md §5 — replaces
        # the reference's fastmath/errstate suppression with a fail-fast mode)
        import jax

        jax.config.update("jax_debug_nans", True)
    try:
        args.run(args)
    except CliError as exc:
        print(f"Error: {exc}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(cli())
