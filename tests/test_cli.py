"""CLI smoke tests (argparse entry point, tiny data, CPU)."""

import csv
import gzip
import io
import os

import numpy as np
import pytest



@pytest.fixture()
def cli_env(tmp_path, monkeypatch):
    """Point PROJECT_DATA_PATH at a tiny staged dataset."""
    monkeypatch.setenv("PROJECT_DATA_PATH", str(tmp_path))
    # reset the config singleton so it picks up the env var
    from doppelspeller.config import Config, set_config

    cfg = Config(
        data_path=str(tmp_path),
        title_block=128,
        query_block=8,
        pair_block=64,
        top_n_predicting=15,
        top_n_training=5,
        gbt_num_boost_round=15,
        gbt_early_stopping_rounds=15,
        score_dtype="float32",
    )
    set_config(cfg)
    yield cfg
    set_config(Config())


def _write_csv(path, columns):
    names = list(columns)
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter="|", lineterminator="\n")
        w.writerow(names)
        w.writerows(zip(*(columns[n] for n in names)))


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f, delimiter="|"))


def _run(capsys, argv, stdin=None, monkeypatch=None):
    """Run the CLI in-process; returns (exit code, stdout)."""
    from doppelspeller.cli import cli

    if stdin is not None:
        monkeypatch.setattr("sys.stdin", io.StringIO(stdin))
    capsys.readouterr()
    code = cli(argv)
    return code, capsys.readouterr().out


def _make_tiny_dataset(cfg):
    rng = np.random.RandomState(0)
    truth_titles = [
        f"{w} holdings {i}" for i, w in enumerate(
            ["alpha", "bravo", "carlo", "delta", "echos", "forte", "gamma",
             "hotel", "india", "julie", "kilos", "limas", "miked", "novel",
             "oscar", "papas", "quick", "romeo", "sierra", "tango"] * 5
        )
    ]
    _write_csv(cfg.ground_truth_path, {
        "company_id": range(1, len(truth_titles) + 1), "name": truth_titles,
    })
    _write_csv(cfg.train_path, {
        "train_index": range(30),
        "name": [truth_titles[i] + "x" for i in range(20)]
        + [f"zzz unknown {i}" for i in range(10)],
        "company_id": [i + 1 for i in range(20)] + [-1] * 10,
    })
    test = {
        "test_index": range(20),
        "name": [truth_titles[i] for i in range(10)]
        + [f"yyy unknown {i}" for i in range(10)],
    }
    _write_csv(cfg.test_path, test)
    _write_csv(cfg.test_with_actuals_path, dict(
        test, company_id=[i + 1 for i in range(10)] + [-1] * 10,
    ))


def test_cli_full_flow(cli_env, capsys):
    cfg = cli_env
    _make_tiny_dataset(cfg)

    code, _ = _run(capsys, ["-vv", "build-index"])
    assert code == 0
    assert os.path.exists(cfg.index_path)

    code, _ = _run(capsys, ["-v", "train-model"])
    assert code == 0
    assert os.path.exists(cfg.model_path)

    code, _ = _run(capsys, ["-v", "generate-predictions"])
    assert code == 0
    assert os.path.exists(cfg.final_output_path)

    code, out = _run(capsys, ["-v", "get-predictions-accuracy"])
    assert code == 0
    assert "Correctly matched titles" in out

    # multi-device mesh: same output file contents
    single = _read_csv(cfg.final_output_path)
    code, _ = _run(capsys, ["-v", "generate-predictions", "--devices", "8",
                            "--platform", "cpu"])
    assert code == 0
    assert _read_csv(cfg.final_output_path) == single

    # exact queries must all be correct (stage 1), rows sorted by test_index
    assert [int(r["test_index"]) for r in single] == list(range(20))
    assert [int(r["title_id"]) for r in single[:10]] == list(range(1, 11))


def test_cli_single_title(cli_env, capsys):
    cfg = cli_env
    _make_tiny_dataset(cfg)
    _run(capsys, ["-v", "train-model"])
    code, out = _run(capsys, ["-v", "closest-search-single-title", "-t",
                              "alpha holdings 0"])
    assert code == 0
    assert "match_title_id" in out
    # an empty title is a usage error, not a crash
    assert _run(capsys, ["closest-search-single-title", "-t", "  "])[0] == 1


def test_cli_serve(cli_env, capsys, monkeypatch):
    """The serve loop answers bare-title, JSON-single and batch requests,
    survives malformed input, and keeps one warm engine across requests."""
    import json

    cfg = cli_env
    _make_tiny_dataset(cfg)
    _run(capsys, ["-v", "train-model"])

    requests = "\n".join([
        "alpha holdings 0",
        json.dumps({"id": 42, "title": "bravo holdngs 1"}),
        json.dumps({"titles": ["carlo holdings 2", "zzz no such co"]}),
        "{not json",
        # a bare string is iterable — must be rejected, not matched per char
        json.dumps({"titles": "carlo holdings 2"}),
        json.dumps({"titles": ["ok", 7]}),
        json.dumps({"titles": []}),
        "",
    ]) + "\n"
    code, out = _run(capsys, ["-v", "serve", "--no-warmup"], requests,
                     monkeypatch)
    assert code == 0
    lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    assert len(lines) == 7
    exact, single, batch, bad, str_titles, mixed_titles, empty = lines
    assert exact["match_title_id"] == 1 and exact["prediction"] == 1.0
    assert single["test_index"] == 42 and single["match_title_id"] == 2
    assert [x["match_title_id"] for x in batch["results"]] == [3, -1]
    assert batch["results"][0]["prediction"] == 1.0
    assert "error" in bad
    assert "list of strings" in str_titles.get("error", "")
    assert "list of strings" in mixed_titles.get("error", "")
    assert empty == {"results": [], "latency_ms": 0.0}

    # mesh serving: same answers from an 8-device sharded engine
    code, out = _run(capsys, ["-v", "serve", "--no-warmup", "--devices", "8",
                              "--platform", "cpu"], requests, monkeypatch)
    assert code == 0
    mlines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    assert [m.get("match_title_id") for m in mlines[:2]] == [1, 2]
    assert [x["match_title_id"] for x in mlines[2]["results"]] == [3, -1]


def test_cli_stage_example_data(cli_env, tmp_path, capsys):
    src = tmp_path / "src"
    src.mkdir()
    with gzip.open(src / "example_truth.csv.gz", "wb") as f:
        f.write(b"company_id|name\n1|abc\n")
    code, out = _run(capsys, ["stage-example-data-set", "--source", str(src)])
    assert code == 0 and "staged" in out
    assert os.path.exists(cli_env.path("example_truth.csv"))


@pytest.mark.parametrize("argv", [
    ["serve", "--profile", "bogus"],
    ["closest-search-single-title"],          # -t is required
    ["no-such-command"],
    [],
])
def test_cli_rejects_bad_arguments(argv, capsys):
    """argparse usage errors exit with code 2 before any work starts."""
    from doppelspeller.cli import cli

    with pytest.raises(SystemExit) as exc:
        cli(argv)
    assert exc.value.code == 2


def test_cli_parser_keeps_every_command_and_option():
    from doppelspeller.cli import build_parser

    p = build_parser()
    a = p.parse_args(["-vv", "serve", "--no-warmup", "--devices", "4",
                      "--platform", "cpu", "--profile", "throughput"])
    assert (a.verbose, a.command, a.warmup, a.devices, a.platform,
            a.profile) == (2, "serve", False, 4, "cpu", "throughput")
    assert p.parse_args(["serve"]).warmup is True
    for cmd in ("build-index", "train-model", "generate-predictions"):
        a = p.parse_args([cmd, "--devices", "2"])
        assert (a.devices, a.platform) == (2, None)
    a = p.parse_args(["closest-search-single-title", "--title-to-search", "x"])
    assert a.title == "x"
    assert p.parse_args(["get-predictions-accuracy"]).verbose is None
    assert p.parse_args(["stage-example-data-set"]).source


def test_cli_version(capsys):
    from doppelspeller import __version__
    from doppelspeller.cli import cli

    with pytest.raises(SystemExit) as exc:
        cli(["--version"])
    assert exc.value.code == 0
    assert __version__ in capsys.readouterr().out


def test_serve_config_profiles():
    from doppelspeller.cli import serve_config
    from doppelspeller.config import Config

    cfg = Config(data_path="/tmp/x")
    lat = serve_config(cfg, "latency")
    assert (lat.query_block, lat.dispatch_blocks, lat.model_slab) == (8, 1, 128)
    assert serve_config(cfg, "throughput") is cfg
    with pytest.raises(ValueError):
        serve_config(cfg, "bogus")
