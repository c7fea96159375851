"""The port's HTTP server (k8s_device_plugin_tpu_torch/models/http_server.py)
side by side with the JAX package's, on the CPU.

Both serve GPTConfig.tiny() in float32 at page 4 from the same flax
weights (converted for the port), with overload control and the SLO plane
on, as the JAX server's own module fixture serves it.  The same requests
go to both, one at a time and in the same order, so both engines split
their sampling keys on the same schedule: greedy, sampled (n=2 included),
stop and logit-bias tokens must be equal, logprobs within 1e-5 (float32
log-softmax of logits that differ by summation order), and status codes,
shed headers, debug key sets, the params fingerprint and the KV-tier
routes must answer alike.  The canary prober captures its oracle on the
JAX replica and must get ``match`` on the port's.
"""

import dataclasses
import importlib.util
import json
import os
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_device_plugin_tpu.models import engine as jax_engine
from k8s_device_plugin_tpu.models import http_server as jax_http
from k8s_device_plugin_tpu.models import transformer as jax_tf
from k8s_device_plugin_tpu.utils.metrics import MetricsRegistry as JaxRegistry
from k8s_device_plugin_tpu.utils.spans import SpanRecorder as JaxSpans
from k8s_device_plugin_tpu_torch import convert
from k8s_device_plugin_tpu_torch.models import engine as port_engine
from k8s_device_plugin_tpu_torch.models import http_server as port_http
from k8s_device_plugin_tpu_torch.models import transformer as port_tf
from k8s_device_plugin_tpu_torch.utils.metrics import MetricsRegistry as PortRegistry
from k8s_device_plugin_tpu_torch.utils.spans import SpanRecorder as PortSpans

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LP_TOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    """(jax server, port server, flax params): one fixture for the module,
    so the JAX side compiles its step shapes once."""
    cfg = dataclasses.replace(jax_tf.GPTConfig.tiny(), max_seq=32)
    params = jax_tf.TransformerLM(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    paged = dict(page_size=4, num_pages=32, max_pages_per_seq=8)
    jreg = JaxRegistry()
    jeng = jax_engine.ServingEngine(
        cfg, params, jax_tf.PagedConfig(**paged), max_slots=3,
        metrics=jax_engine.EngineMetrics(jreg), spans=JaxSpans(), overload=True, slo=True,
    )
    jsrv = jax_http.EngineServer(jeng, host="127.0.0.1", port=0, registry=jreg,
                                 request_timeout_s=120, enable_trace=True).start()
    pcfg = dataclasses.replace(port_tf.GPTConfig.tiny(), max_seq=32)
    preg = PortRegistry()
    peng = port_engine.ServingEngine(
        pcfg, convert.flax_to_state_dict(params), port_tf.PagedConfig(**paged), max_slots=3,
        metrics=port_engine.EngineMetrics(preg), spans=PortSpans(), overload=True, slo=True,
        device="cpu",
    )
    psrv = port_http.EngineServer(peng, host="127.0.0.1", port=0, registry=preg,
                                  request_timeout_s=120, enable_trace=True).start()
    yield jsrv, psrv, params
    jsrv.stop()
    psrv.stop()


def _request(port, path, payload=None, headers=None, timeout=120):
    """(status, headers, raw body) of one request; errors are answers too."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method="GET" if data is None else "POST",
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _both(pair, path, payload=None, headers=None):
    """The same request to the JAX server, then the port's: two (status,
    headers, body) triples."""
    jsrv, psrv, _ = pair
    return (_request(jsrv.port, path, payload, headers),
            _request(psrv.port, path, payload, headers))


def _json(answer):
    return json.loads(answer[2])


def _stream(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps({**payload, "stream": True}).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    events = []
    with urllib.request.urlopen(req, timeout=120) as resp:
        assert resp.headers["Content-Type"].startswith("text/event-stream")
        for raw in resp:
            line = raw.decode().strip()
            if line.startswith("data: "):
                events.append(json.loads(line[len("data: "):]))
                if events[-1].get("done") or events[-1].get("error"):
                    break
    return events


def _keys(obj):
    """The nested key set of a JSON object (lists are not walked)."""
    if not isinstance(obj, dict):
        return None
    return {k: _keys(v) for k, v in obj.items()}


@pytest.mark.parametrize(
    "payload",
    [
        {"prompt": [3, 141, 59], "max_new_tokens": 6},
        {"prompt": [400, 2, 2, 17, 9, 11, 5], "max_new_tokens": 10},
        {"prompt": [9], "max_new_tokens": 4},
    ],
    ids=["p3", "p7", "p1"],
)
def test_greedy_unary_and_streamed_tokens_equal(pair, payload):
    j, p = _both(pair, "/generate", payload)
    assert j[0] == p[0] == 200
    assert _json(p)["tokens"] == _json(j)["tokens"]
    assert len(_json(p)["tokens"]) == payload["max_new_tokens"]
    jsrv, psrv, _ = pair
    jev, pev = _stream(jsrv.port, payload), _stream(psrv.port, payload)
    assert [e.get("token") for e in pev] == [e.get("token") for e in jev]
    assert pev[-1]["done"] and pev[-1]["tokens"] == _json(j)["tokens"]
    assert {k for e in pev for k in e} == {k for e in jev for k in e}


@pytest.mark.parametrize(
    "payload",
    [
        {"prompt": [3, 141, 59], "max_new_tokens": 8, "temperature": 0.8, "top_k": 50},
        {"prompt": [7, 7, 3], "max_new_tokens": 8, "temperature": 1.0, "top_p": 0.9},
        {"prompt": [5, 6, 7], "max_new_tokens": 6, "temperature": 0.7, "n": 2},
    ],
    ids=["topk", "topp", "n2"],
)
def test_sampled_tokens_and_logprobs_equal(pair, payload):
    """Sampled tokens equal under one key (both servers start from
    PRNGKey(0) and see the same request sequence), n=2 included; the
    logprobs of every choice within 1e-5 and each at most 0."""
    j, p = _both(pair, "/generate", {**payload, "logprobs": True})
    assert j[0] == p[0] == 200
    jb, pb = _json(j), _json(p)
    assert pb["tokens"] == jb["tokens"]
    choices = list(zip(pb.get("choices", [pb]), jb.get("choices", [jb])))
    for pc, jc in choices:
        assert pc["tokens"] == jc["tokens"]
        np.testing.assert_allclose(pc["logprobs"], jc["logprobs"], rtol=0, atol=LP_TOL)
        assert all(np.isfinite(pc["logprobs"])) and max(pc["logprobs"]) <= 0.0
    if payload.get("n") == 2:
        assert len(choices) == 2


def test_greedy_logprobs_equal(pair):
    j, p = _both(pair, "/generate", {"prompt": [1, 2, 3, 4, 5], "max_new_tokens": 7,
                                     "logprobs": True})
    assert _json(p)["tokens"] == _json(j)["tokens"]
    np.testing.assert_allclose(_json(p)["logprobs"], _json(j)["logprobs"], rtol=0, atol=LP_TOL)


@pytest.mark.parametrize(
    "extra",
    [
        {"logit_bias": {"17": 50.0, "3": -100.0}},
        {"logit_bias": {"101": 8.0}, "temperature": 0.9, "logprobs": True},
        "stop",
    ],
    ids=["bias-greedy", "bias-sampled", "stop"],
)
def test_stop_and_logit_bias_equal(pair, extra):
    base = {"prompt": [12, 13, 14], "max_new_tokens": 8}
    if extra == "stop":
        # A stop sequence taken from the greedy stream itself, so it hits.
        j, _ = _both(pair, "/generate", base)
        toks = _json(j)["tokens"]
        payload = {**base, "stop": [toks[3:5], [511, 510]]}
    else:
        payload = {**base, **extra}
    j, p = _both(pair, "/generate", payload)
    assert j[0] == p[0] == 200
    assert _json(p)["tokens"] == _json(j)["tokens"]
    if extra == "stop":
        assert _json(p)["tokens"] == toks[:3]
    elif "logprobs" in payload:
        np.testing.assert_allclose(_json(p)["logprobs"], _json(j)["logprobs"], rtol=0,
                                   atol=LP_TOL)
    else:
        assert 17 in _json(p)["tokens"] and 3 not in _json(p)["tokens"]


@pytest.mark.parametrize(
    "payload, headers",
    [
        ({"max_new_tokens": 4}, None),  # no prompt: 400
        ({"prompt": [1, 2], "max_new_tokens": "x"}, None),  # 400
        ({"prompt": [[1], 2], "max_new_tokens": 4}, None),  # nested prompt
        ({"prompt": [], "max_new_tokens": 4}, None),  # 422 empty prompt
        ({"prompt": [1, 2], "max_new_tokens": 4, "top_p": 0.0}, None),  # 422
        ({"prompt": [1, 2], "max_new_tokens": 40}, None),  # 422 max_len
        ({"prompt": [1, 2], "max_new_tokens": 4, "n": 9}, None),  # 422
        ({"prompt": [1, 2], "max_new_tokens": 4, "n": 2, "stream": True}, None),  # 422
        ({"prompt": [1, 2], "max_new_tokens": 4, "logit_bias": {"9999": 1.0}}, None),
        ({"prompt": [1, 2], "max_new_tokens": 4, "stop": [[]]}, None),
        ({"prompt": [1, 2], "max_new_tokens": 4, "adapter": 0}, None),
        ({"prompt": [1, 2], "max_new_tokens": 4}, {"X-Request-Deadline": "0"}),  # 504
        ({"prompt": [1, 2], "max_new_tokens": 4}, {"X-Request-Priority": "urgent"}),
    ],
)
def test_status_codes_equal(pair, payload, headers):
    j, p = _both(pair, "/generate", payload, headers)
    assert p[0] == j[0] and p[0] in (400, 422, 504)
    assert set(_json(p)) == set(_json(j))
    if p[0] == 504:
        assert _json(p)["shed"] == _json(j)["shed"] == "expired"


def test_load_shed_is_503_with_retry_after_and_x_shed(pair):
    jsrv, psrv, _ = pair
    answers = []
    for srv in (jsrv, psrv):
        ctl = srv.engine.overload
        old, ctl.cfg.max_queue = ctl.cfg.max_queue, 0
        try:
            answers.append(_request(srv.port, "/generate", {"prompt": [1, 2],
                                                            "max_new_tokens": 2}))
        finally:
            ctl.cfg.max_queue = old
    j, p = answers
    assert p[0] == j[0] == 503
    assert p[1]["X-Shed"] == j[1]["X-Shed"] == "queue_full"
    assert float(p[1]["Retry-After"]) >= 1.0
    assert _json(p) == {**_json(j), "trace_id": _json(p)["trace_id"]}


def test_drain_and_fence_answers_equal(pair):
    """Draining and fenced replicas answer 503 + Retry-After without X-Shed
    on /generate and /healthz, alike."""
    jsrv, psrv, _ = pair
    for flag in ("_draining", "_fence"):
        for srv in (jsrv, psrv):
            getattr(srv, flag).set()
        try:
            for path, payload in (("/generate", {"prompt": [1], "max_new_tokens": 2}),
                                  ("/healthz", None)):
                j, p = _both(pair, path, payload)
                assert p[0] == j[0] == 503
                assert "Retry-After" in p[1] and "X-Shed" not in p[1]
                assert set(_json(p)) == set(_json(j))
        finally:
            for srv in (jsrv, psrv):
                getattr(srv, flag).clear()


@pytest.mark.parametrize(
    "path",
    ["/debug/state?summary=1", "/debug/state", "/debug/admission", "/debug/slo",
     "/debug/usage", "/debug/profile", "/debug/kvcache", "/debug/disagg", "/debug/fabric",
     "/debug/incidents", "/debug/flight", "/debug/spans", "/healthz"],
)
def test_debug_routes_answer_the_same_keys(pair, path):
    """After a request on each, every debug route answers 200 with the
    same nested key set on both servers."""
    _both(pair, "/generate", {"prompt": [5, 6, 7], "max_new_tokens": 3, "tenant": "keys"})
    j, p = _both(pair, path)
    assert p[0] == j[0] == 200
    jb, pb = _json(j), _json(p)
    if path == "/debug/state":
        # The engine block's keys (the port adds its "device" block), the
        # fence block's and the summary's.
        assert pb["engine"].pop("device")["type"] == "cpu"
        assert _keys(pb["engine"]) == _keys(jb["engine"])
        assert _keys(pb["fence"]) == _keys(jb["fence"])
        assert set(pb) == set(jb)
    elif path in ("/debug/flight", "/debug/spans", "/debug/incidents"):
        assert set(pb) == set(jb)
    else:
        assert _keys(pb) == _keys(jb)


def test_summary_fields_and_params_fingerprint_equal(pair):
    from k8s_device_plugin_tpu.models import engine_snapshot as jax_snap

    _, _, params = pair
    j, p = _both(pair, "/debug/state?summary=1")
    jb, pb = _json(j), _json(p)
    assert pb["params_fingerprint"] == jb["params_fingerprint"] == jax_snap.params_fingerprint(
        params)
    for key in ("role", "draining", "fenced", "loop_alive", "fabric_digest"):
        assert pb[key] == jb[key], key


def test_kv_tier_routes_answer_the_same(pair):
    """The routes whose engine half is the KV tiers answer what an engine
    without tiers answers: the tier snapshots, the role flip, the fabric
    verbs, a snapshot stream of no entries, and a /v1/prefill stream."""
    j, p = _both(pair, "/debug/kvcache")
    assert _json(p) == _json(j)
    for body, code in (({"role": "unified"}, 200), ({"role": "prefill"}, 400),
                       ({"role": "bogus"}, 400), ({}, 400)):
        j, p = _both(pair, "/debug/role", body)
        assert p[0] == j[0] == code
        assert _json(p) == _json(j)
    j, p = _both(pair, "/debug/fabric/pull", {"prompt": [1, 2, 3, 4, 5], "source": "h:1"})
    assert p[0] == j[0] == 502 and _json(p) == _json(j)
    j, p = _both(pair, "/debug/fabric/drop", {"prompt": [1, 2, 3, 4, 5]})
    assert p[0] == j[0] == 200 and _json(p) == _json(j)
    j, p = _both(pair, "/debug/snapshot")
    assert p[0] == j[0] == 200
    for h in ("X-Snapshot-Layout", "X-Snapshot-Params", "X-Snapshot-Entries"):
        assert p[1][h] == j[1][h], h
    # The bodies differ only in the preamble's creation time.
    assert len(p[2]) == len(j[2]) and p[2][:8] == j[2][:8] == b"TPUKVSN1"
    j, p = _both(pair, "/debug/snapshot", headers={"Range": "bytes=0-"})
    assert p[0] == j[0] == 416
    j, p = _both(pair, "/debug/snapshot", headers={"X-Snapshot-Params": "deadbeef"})
    assert p[0] == j[0] == 409 and _json(p) == _json(j)
    prompt = [21, 22, 23, 24, 25, 26, 27, 28, 29, 30]
    j, p = _both(pair, "/v1/prefill", {"prompt": prompt})
    assert p[0] == j[0] == 200
    assert p[1]["X-Snapshot-Entries"] == j[1]["X-Snapshot-Entries"] == "2"
    assert p[1]["X-Snapshot-Layout"] == j[1]["X-Snapshot-Layout"]
    assert len(p[2]) == len(j[2])
    j, p = _both(pair, "/debug/disagg")
    assert _json(p) == _json(j)


def test_canary_prober_captures_on_jax_and_matches_on_port(pair):
    from k8s_device_plugin_tpu.router.prober import CanaryConfig, CanaryProber

    jsrv, psrv, _ = pair
    targets = [f"127.0.0.1:{jsrv.port}"]
    prober = CanaryProber(
        lambda: list(targets),
        config=CanaryConfig(interval_s=0.05, probe_tokens=3, prompts=((5, 6, 7),),
                            via_router=False),
    )
    assert prober.probe_once() == {targets[0]: "capture"}
    targets[:] = [f"127.0.0.1:{psrv.port}"]
    assert prober.probe_once() == {targets[0]: "match"}
    # The port's replica keeps matching.
    assert prober.probe_once() == {targets[0]: "match"}


def test_port_metrics_pass_the_lint(pair):
    spec = importlib.util.spec_from_file_location(
        "metrics_lint", os.path.join(REPO, "tools", "metrics_lint.py"))
    metrics_lint = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(metrics_lint)
    _, psrv, _ = pair
    assert metrics_lint.lint_url(f"http://127.0.0.1:{psrv.port}/metrics") == []
    j, p = _both(pair, "/metrics")
    families = lambda text: {line.split()[2] for line in text.decode().splitlines()  # noqa: E731
                             if line.startswith("# TYPE")}
    assert families(p[2]) == families(j[2])


def test_trace_capture_writes_a_torch_profiler_trace(pair):
    _, psrv, _ = pair
    status, _, body = _request(psrv.port, "/debug/trace", {"seconds": 0.1})
    assert status == 200
    tdir = json.loads(body)["trace_dir"]
    assert any(name.endswith(".json") for name in os.listdir(tdir))


def test_step_capture_traces_the_next_steps(pair):
    """POST /debug/profile/capture spans the next engine steps (a request
    in flight supplies them) and answers its trace dir; 400 on a bad
    step count, as the reference's."""
    import threading

    import time

    _, psrv, _ = pair
    answer = []
    capture = threading.Thread(target=lambda: answer.append(_request(
        psrv.port, "/debug/profile/capture", {"steps": 2, "timeout_s": 30})))
    capture.start()
    time.sleep(1.0)  # the capture is waiting for steps: give it some
    assert _request(psrv.port, "/generate", {"prompt": [8, 9, 10], "max_new_tokens": 20})[0] == 200
    capture.join()
    status, _, body = answer[0]
    assert status == 200
    out = json.loads(body)
    assert out["steps_requested"] == 2 and 0 < out["steps_captured"] <= 2
    assert any(name.endswith(".json") for name in os.listdir(out["trace_dir"]))
    assert _request(psrv.port, "/debug/profile/capture", {"steps": 0})[0] == 400


@pytest.mark.parametrize(
    "argv, flag",
    [
        (["--spec-gamma", "4"], "--spec-gamma"),
        (["--adapters", "a,b"], "--adapters"),
        (["--tp", "2"], "--tp"),
        (["--checkpoint-dir", "/ckpt"], "--checkpoint-dir"),
    ],
)
def test_cli_refuses_what_the_port_does_not_serve(argv, flag, tmp_path):
    """``--spec-gamma``, ``--adapters``, ``--tp`` and ``--checkpoint-dir``
    (refused until the port served them) are taken.  Three build an engine
    here: a spec engine with its w8 draft, a multi-LoRA engine over two
    adapter directories, an engine on a checkpoint's weights; the
    directories are written here (``convert.save_flax_params`` / the port's
    CheckpointManager) in place of the case's placeholder paths.  ``--tp
    2`` parses, with the flags it serves over its mesh too (its server runs
    over two ranks in tests/test_torch_tp_serving.py)."""
    if flag == "--tp":
        assert port_http.parse_args(argv).tp == 2
        assert port_http.parse_args(argv + ["--spec-gamma", "2"]).spec_gamma == 2
        return
    from k8s_device_plugin_tpu_torch.models import checkpoint, lora

    tiny = ["--device=cpu", "--dtype=float32", "--hidden=64", "--layers=2", "--heads=4",
            "--kv-heads=2", "--vocab=512", "--page-size=4", "--num-pages=32",
            "--max-pages-per-seq=8", "--slots=2", "--watchdog=0"]
    cfg = port_tf.GPTConfig(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
                            intermediate_size=192, max_seq=32, num_kv_heads=2,
                            dtype=torch.float32)
    if flag == "--adapters":
        dirs = []
        for i in range(2):
            tree = port_tf.init_params(dataclasses.replace(cfg, lora_rank=2), seed=i)
            dirs.append(str(tmp_path / f"adapter_{i}"))
            checkpoint.CheckpointManager(dirs[-1]).save(tree, 0)
        argv = ["--adapters", ",".join(dirs)]
    elif flag == "--checkpoint-dir":
        checkpoint.CheckpointManager(tmp_path / "ckpt").save(port_tf.init_params(cfg, seed=5), 7)
        argv = ["--checkpoint-dir", str(tmp_path / "ckpt")]
    eng = port_http.build_engine(port_http.parse_args(tiny + argv))
    if flag == "--spec-gamma":
        assert eng._spec_gamma == 4 and eng.draft_model.config.quant == "w8"
        assert eng._decode_block == 1 and eng._overlap_steps == 0
    elif flag == "--adapters":
        assert eng.cfg.lora_serve == 2 and eng.cfg.lora_rank == 2
        assert lora.lora_rank_of(eng.model.state_dict()) == 2
    else:
        want = port_tf.init_params(cfg, seed=5)
        assert torch.equal(eng.model.state_dict()["embed.embedding"], want["embed.embedding"])
    [req] = eng.run([([1, 2, 3], 3)], **({"adapter": 1} if flag == "--adapters" else {}))
    assert len(req.tokens) == 3


@pytest.mark.parametrize("argv, match", [
    (["--adapters", "a", "--quant", "w8"], "--quant is mutually exclusive"),
    (["--adapters", "a", "--spec-gamma", "2"], "not supported with --spec-gamma"),
    (["--spec-gamma", "2", "--quant", "w8"], "SELF-draft"),
])
def test_cli_refuses_the_reference_pairs(argv, match):
    with pytest.raises(SystemExit, match=match):
        port_http.parse_args(argv)


DEPLOYMENT_FLAGS = [
    "--hidden=1024", "--layers=8", "--heads=16", "--kv-heads=4", "--page-size=16",
    "--num-pages=512", "--max-pages-per-seq=32", "--slots=8", "--decode-block=16",
    "--admission=optimistic", "--prefill-chunk=256", "--kv-retain=1", "--kv-host-cache-mb=512",
    "--overload=1", "--overload-target-wait=0.5", "--overload-max-queue=512", "--slo=1",
    "--watchdog=1", "--watchdog-min-deadline=5", "--watchdog-grace=120",
    "--snapshot-dir=/var/lib/tpu-snapshot", "--snapshot-interval=60", "--dump-budget-mb=256",
    "--http-port=8000", "--compilation-cache-dir=/var/cache/xla",
]


def test_cli_takes_the_deployment_flags():
    """Every flag of deploy/k8s-deploy-serve-http.yaml parses, nothing cut;
    the tier flags default as the reference's (tier 1 on, a 64 MiB arena)."""
    manifest = open(os.path.join(REPO, "deploy", "k8s-deploy-serve-http.yaml")).read()
    for flag in DEPLOYMENT_FLAGS:
        assert f'"{flag}"' in manifest, flag
    args = port_http.parse_args(DEPLOYMENT_FLAGS)
    assert args.admission == "optimistic" and args.decode_block == 16
    assert args.kv_retain == 1 and args.kv_host_cache_mb == 512
    assert args.snapshot_dir == "/var/lib/tpu-snapshot" and args.snapshot_interval == 60
    defaults = port_http.parse_args([])
    assert (defaults.kv_retain, defaults.kv_host_cache_mb, defaults.role) == (1, 64, "unified")


@pytest.mark.parametrize(
    "argv, attr, value",
    [
        (["--snapshot-interval", "15"], "snapshot_interval", 15.0),
        (["--warm-self", "10.0.0.7:8000"], "warm_self", "10.0.0.7:8000"),
        (["--handoff-timeout", "2.5"], "handoff_timeout", 2.5),
    ],
)
def test_cli_takes_the_warm_restart_and_handoff_flags(argv, attr, value):
    """The flags the reference pairs with the tiers parse to what the
    server is built from."""
    assert getattr(port_http.parse_args(argv), attr) == value


def _serve_process(tmp_path, name, extra):
    """``python -m ...http_server`` on the CPU at tiny widths: (process,
    port, log path)."""
    import re
    import subprocess
    import sys
    import time

    log = tmp_path / f"{name}.log"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.Popen(
        [sys.executable, "-m", "k8s_device_plugin_tpu_torch.models.http_server",
         "--device", "cpu", "--dtype", "float32", "--hidden", "64", "--layers", "2",
         "--heads", "4", "--kv-heads", "2", "--vocab", "512", "--page-size", "4",
         "--num-pages", "64", "--slots", "2", "--decode-block", "16",
         "--admission", "optimistic", "--prefill-chunk", "256", "--http-port", "0", *extra],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=open(log, "w"),
    )
    port, deadline = None, time.monotonic() + 120
    while port is None and time.monotonic() < deadline:
        assert proc.poll() is None, log.read_text()
        m = re.search(r"serving on :(\d+)", log.read_text())
        port = int(m.group(1)) if m else None
        time.sleep(0.1)
    assert port is not None, log.read_text()
    return proc, port, log


def test_sigterm_saves_a_snapshot_and_a_restart_serves_warm(tmp_path):
    """The deployment's warm restart on the CPU: a server on the tier and
    snapshot flags serves a shared-prefix prompt, SIGTERM drains it and
    the drain writes the snapshot; a second server on the same directory
    loads it before serving, and the same prompt restores from the arena
    (host hits, no prefill of the prefix) with the cold server's tokens."""
    import signal

    snap_dir = tmp_path / "snap"
    flags = ["--kv-retain", "1", "--kv-host-cache-mb", "8", "--snapshot-dir", str(snap_dir),
             "--snapshot-interval", "60"]
    prompt = [(7 * i) % 500 + 1 for i in range(12)]  # three full pages
    tokens = []
    for name in ("cold", "warm"):
        proc, port, log = _serve_process(tmp_path, name, flags)
        try:
            status, _, body = _request(port, "/generate", {"prompt": prompt, "max_new_tokens": 6})
            assert status == 200
            tokens.append(json.loads(body)["tokens"])
            kv = json.loads(_request(port, "/debug/kvcache")[2])
            state = json.loads(_request(port, "/debug/state")[2])["fence"]["snapshot"]
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=60) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        text = log.read_text()
        assert state["dir"] == str(snap_dir) and state["interval_s"] == 60.0
        if name == "cold":
            assert kv["hits"]["host"] == 0
            assert (snap_dir / "kv_arena.snapshot").exists()
            assert "'ok': False, 'reason': 'missing'" in text
        else:
            assert "kv snapshot restore: {'ok': True, 'restored': 3" in text
            assert kv["hits"]["host"] >= 3 and kv["restores"] >= 3
    assert tokens[1] == tokens[0]


def test_server_process_serves_and_drains_on_sigterm(tmp_path):
    """``python -m ...http_server`` on the CPU at tiny widths with the
    deployment's admission flags: it serves, and SIGTERM drains it to exit
    code 0."""
    import signal

    proc, port, log = _serve_process(tmp_path, "server", [])
    try:
        status, _, body = _request(port, "/generate", {"prompt": [1, 2, 3], "max_new_tokens": 5})
        assert status == 200 and len(json.loads(body)["tokens"]) == 5
        status, _, body = _request(port, "/debug/state?summary=1")
        assert status == 200 and json.loads(body)["loop_alive"] is True
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        assert "draining" in log.read_text()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
