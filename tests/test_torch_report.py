"""The port's telemetry report (`python -m dorpatch_tpu_torch.observe.report`)
against the JAX package's (`dorpatch_tpu.observe.report`) on the same
directories, all written by the port on the CPU: a main-path run, a
training run (`train.py --telemetry-dir`), a serve run, a farm, a recert
directory and a fleet (client, gateway, backend). The text and the
`--json` output are equal, with two differences mapped before comparing:
the manifest's backend line names torch's version where the JAX report,
which knows only jax's, prints "jax ?", and a recert directory's default
baseline is each package's own file."""

import json
import os
import re

import numpy as np
import pytest
import torch

from dorpatch_tpu.observe import report as jax_report
from dorpatch_tpu_torch import observe
from dorpatch_tpu_torch.observe import report

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG, N_CLASSES = 32, 5


@pytest.fixture(autouse=True)
def two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _run_both(capsys, argv):
    """{package: (exit code, stdout)} of both reports' `main(argv)`."""
    out = {}
    for name, mod in (("torch", report), ("jax", jax_report)):
        capsys.readouterr()
        rc = mod.main(list(argv))
        out[name] = (rc, capsys.readouterr().out)
    return out


def _jax_wording(text: str) -> str:
    text = re.sub(r"(\) )torch \S+$", r"\1jax ?", text, flags=re.M)
    return text.replace("dorpatch_tpu_torch", "dorpatch_tpu")


def _assert_equal_reports(capsys, argv, expect_rc=0):
    both = _run_both(capsys, argv)
    t_rc, t_out = both["torch"]
    j_rc, j_out = both["jax"]
    assert t_rc == j_rc == expect_rc, (t_out, j_out)
    assert _jax_wording(t_out) == j_out
    jboth = _run_both(capsys, list(argv) + ["--json"])
    assert jboth["torch"][0] == jboth["jax"][0] == expect_rc
    if expect_rc == 2:       # a usage error: a message, no JSON
        assert _jax_wording(jboth["torch"][1]) == jboth["jax"][1]
    else:
        assert json.loads(_jax_wording(jboth["torch"][1])) == json.loads(
            jboth["jax"][1])
    return t_out


def _stub(x):
    s = x.mean(dim=(1, 2, 3))
    return torch.nn.functional.one_hot(
        (s * 7).to(torch.int32).long() % N_CLASSES, N_CLASSES).float()


def _images(n, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.0, 1.0, (n, 4, 4, 3)).astype(np.float32)
    return np.kron(base, np.ones((1, IMG // 4, IMG // 4, 1), np.float32))


def _serve_dir(root, n=3, trace="r"):
    """A stub-victim service's results dir after `n` requests, each with
    its own trace id: `root`/serve."""
    from dorpatch_tpu_torch.config import DefenseConfig, ServeConfig
    from dorpatch_tpu_torch.serve import CertifiedInferenceService

    svc = CertifiedInferenceService(
        _stub, N_CLASSES, IMG,
        serve_cfg=ServeConfig(max_batch=2, bucket_sizes=(1, 2),
                              deadline_ms=20000.0, flush_fraction=0.01),
        defense_cfg=DefenseConfig(ratios=(0.1,), chunk_size=64),
        result_dir=os.path.join(root, "serve"), device="cpu")
    with svc:
        for i, img in enumerate(_images(n)):
            svc.predict(img, trace_id=f"{trace}{i}")
    return os.path.join(root, "serve")


def test_report_of_a_main_path_run_equals_jax(tmp_path, capsys,
                                              monkeypatch):
    """The CLI's main path (a shallow CIFAR ResNet-18 at 16 px, batch 2,
    2 iterations): run.json, events.jsonl, heartbeat_0.jsonl and
    metrics.jsonl render as the JAX report renders them."""
    from dorpatch_tpu_torch.cli import build_parser, config_from_args
    from dorpatch_tpu_torch.models import registry
    from dorpatch_tpu_torch.models.small import CifarResNet18
    from dorpatch_tpu_torch.pipeline import run_experiment

    _, init = registry._FAMILIES["cifar_resnet18"]
    monkeypatch.setitem(
        registry._FAMILIES, "cifar_resnet18",
        (lambda n: CifarResNet18(num_classes=n, stage_sizes=(1, 1, 1, 1)),
         init))
    run_experiment(config_from_args(build_parser().parse_args([
        "--device", "cpu", "--synthetic", "--dataset", "cifar10",
        "--base_arch", "resnet18", "--img-size", "16", "-b", "2",
        "--max-iterations", "2", "--sampling-size", "4", "--dropout", "1",
        "--num-batches", "1", "--results-root", str(tmp_path)])))
    run_dir = next(root for root, _, files in os.walk(tmp_path)
                   if "run.json" in files)
    text = _assert_equal_reports(capsys, [run_dir])
    assert "backend: cpu" in text and f"torch {torch.__version__}" in text
    assert "-- phase breakdown" in text and "attack" in text


def test_report_of_a_training_run_equals_jax(tmp_path, capsys):
    """`train.py --telemetry-dir`: the run-telemetry contract of the JAX
    package's training (a `train.epoch` span an epoch, `train.eval`, a
    heartbeat), rendered equally."""
    from dorpatch_tpu_torch import train

    tel = str(tmp_path / "telemetry")
    assert train.main(["--device", "cpu", "--arch", "cifar_vit",
                       "--epochs", "2", "--n-per-class", "10",
                       "--batch-size", "50", "--out", str(tmp_path / "v"),
                       "--telemetry-dir", tel]) == 0
    assert observe.active_event_log() is None
    text = _assert_equal_reports(capsys, [tel])
    assert "train.epoch" in text and "train.eval" in text
    events = [json.loads(line) for line in open(os.path.join(
        tel, "events.jsonl"))]
    epochs = [e for e in events if e.get("name") == "train.epoch"
              and e.get("kind") == "span"]
    assert [e["epoch"] for e in epochs] == [1, 2]
    assert all("train_acc" in e for e in epochs)
    manifest = json.load(open(os.path.join(tel, "run.json")))
    assert manifest["config"]["arch"] == "cifar_vit"
    assert os.path.exists(os.path.join(tel, "heartbeat_0.jsonl"))


def test_report_of_a_serve_run_equals_jax(tmp_path, capsys):
    serve = _serve_dir(str(tmp_path))
    text = _assert_equal_reports(capsys, [serve])
    assert "-- serve --" in text


def test_report_of_a_farm_equals_jax(tmp_path, capsys):
    from dorpatch_tpu_torch.farm.queue import JobQueue
    from dorpatch_tpu_torch.farm.worker import FarmWorker
    from dorpatch_tpu_torch.sweep import append_row

    farm = str(tmp_path / "farm")
    JobQueue(farm).submit_spec({
        "base": {"dataset": "cifar10", "base_arch": "resnet18",
                 "img_size": 32, "batch_size": 2, "synthetic_data": True},
        "axes": {"attack.patch_budget": [0.06, 0.12]}, "max_attempts": 2})

    def runner(job, ctx):
        if job["params"]["attack.patch_budget"] == 0.12:
            raise ValueError("quarantined on purpose")
        append_row(ctx.result_dir, {
            "patch_budget": 0.06, "density": 1e-3, "structured": 1e-3,
            "robust_accuracy": 50.0, "certified_asr_pc": 25.0, "asr": 50.0,
            "point": 0, "images": 2, "seconds": 1.5})
        return {"rows": 1}

    FarmWorker(farm, worker_id="w0", lease_ttl=10.0, poll_interval=0.02,
               heartbeat_interval=0.2, runner=runner, device="cpu").run()
    text = _assert_equal_reports(capsys, [farm])
    assert "quarantined" in text


def test_report_of_a_recert_dir_equals_jax(tmp_path, capsys):
    from dorpatch_tpu_torch.farm.worker import FarmWorker
    from dorpatch_tpu_torch.recert.scheduler import RecertScheduler
    from dorpatch_tpu_torch.sweep import append_row

    spec = {"base": {"dataset": "cifar10", "base_arch": "resnet18",
                     "img_size": 32, "batch_size": 2,
                     "synthetic_data": True},
            "axes": {"attack.patch_budget": [0.06, 0.12]},
            "sweep": {"densities": [0.0], "structureds": [1e-3],
                      "defense_ratio": 0.06}}
    rdir = str(tmp_path / "recert")
    sched = RecertScheduler(rdir, baseline_file=str(tmp_path / "rb.json"))
    empty = _assert_equal_reports(capsys, [rdir]) \
        if os.path.exists(sched.state_path) else None
    for ra, update in ((50.0, True), (40.0, False)):
        gen, farm_dir = sched.begin_generation(spec)

        def runner(job, ctx, ra=ra):
            append_row(ctx.result_dir, {
                "patch_budget": job["params"]["attack.patch_budget"],
                "density": 0.0, "structured": 1e-3, "robust_accuracy": ra,
                "certified_asr_pc": 10.0, "asr": 100.0 - ra, "point": 0,
                "images": 2})
            return {"rows": 1}

        FarmWorker(farm_dir, worker_id="w", lease_ttl=10.0,
                   poll_interval=0.02, heartbeat_interval=0.2,
                   runner=runner, device="cpu").run()
        sched.complete_generation(gen, farm_dir, update_baseline=update)
    assert empty is None
    text = _assert_equal_reports(capsys, [rdir])
    assert "re-certification report" in text and "regressed" in text
    # an inflight generation renders its counts
    sched.begin_generation(spec)
    assert "inflight: generation 3" in _assert_equal_reports(capsys, [rdir])


def test_report_of_a_fleet_equals_jax(tmp_path, capsys):
    """A gateway over a serve backend of the port, with the client's
    books: `--fleet` reconciles client == gateway == backend with no
    orphaned trace id, in both reports alike; a client book that lost a
    request makes both exit 1."""
    from dorpatch_tpu_torch.config import GatewayConfig
    from dorpatch_tpu_torch.gateway import Gateway, GatewayFrontend
    from dorpatch_tpu_torch.serve import HttpFrontend
    from dorpatch_tpu_torch.config import DefenseConfig, ServeConfig
    from dorpatch_tpu_torch.serve import CertifiedInferenceService
    import urllib.request

    svc = CertifiedInferenceService(
        _stub, N_CLASSES, IMG,
        serve_cfg=ServeConfig(max_batch=1, deadline_ms=20000.0),
        defense_cfg=DefenseConfig(ratios=(0.1,), chunk_size=64),
        result_dir=str(tmp_path / "backend" / "serve"), device="cpu")
    client = observe.MetricRegistry()
    seen = client.counter("loadgen_requests_total", "client attempts")
    with svc, HttpFrontend(svc, "127.0.0.1", 0) as fe:
        gw = Gateway(GatewayConfig(
            backends=(f"http://127.0.0.1:{fe.port}",), ok_threshold=1,
            probe_interval_s=60.0), result_dir=str(tmp_path / "gateway"))
        with gw, GatewayFrontend(gw, port=0) as gfe:
            gw.registry.probe_cycle()
            for i, img in enumerate(_images(3)):
                req = urllib.request.Request(
                    f"http://127.0.0.1:{gfe.port}/predict",
                    data=json.dumps({"image": img.tolist()}).encode(),
                    headers={"X-Trace-Id": f"c{i}"})
                with urllib.request.urlopen(req, timeout=60) as r:
                    seen.inc(status=json.loads(r.read())["status"])
    os.makedirs(tmp_path / "client")
    client.dump(str(tmp_path / "client" / "metrics_client.json"))
    dirs = [str(tmp_path / d) for d in ("client", "gateway", "backend")]
    text = _assert_equal_reports(capsys, ["--fleet", *dirs])
    assert "consistent: yes" in text and "orphaned traces: 0" in text
    fleet = report.summarize_fleet_dirs(dirs)
    assert fleet["gateway"]["by_status"] == {"ok": 3}
    assert fleet["requests"]["server_by_status"] == {"ok": 3}
    seen.inc(status="ok")
    client.dump(str(tmp_path / "client" / "metrics_client.json"))
    _assert_equal_reports(capsys, ["--fleet", *dirs], expect_rc=1)


def test_report_usage_errors_equal_jax(tmp_path, capsys):
    _assert_equal_reports(capsys, [str(tmp_path / "missing")], expect_rc=2)
    (tmp_path / "empty").mkdir()
    _assert_equal_reports(capsys, [str(tmp_path / "empty")], expect_rc=2)
    _assert_equal_reports(capsys, ["--fleet", str(tmp_path / "missing")],
                          expect_rc=2)
