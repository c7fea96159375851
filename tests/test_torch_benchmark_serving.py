"""The port's inference benchmarks (``--model serving`` and ``--model
gpt-decode``) against the JAX package's.

Each side's serving benchmark runs once (module fixtures): the reference's
``main`` on the CPU, the port's ``run_serving`` with ``device="cpu"``, both
at ``--tiny --router-replicas 0 --requests 8 --slots 4 --prompt-len 16
--decode-tokens 48`` in float32, the port from the reference's own weights
(``TransformerLM(cfg).init(PRNGKey(0), ...)``, as its ``run_serving``
draws them) converted with ``convert.flax_to_state_dict``.  The records
must have the same keys, block by block; the port prints null exactly for
``tp`` and the router-side blocks; the counts that follow from the schedule
alone (the KV-tier phase's hits and preemptions, the step profile's
steps and occupancy, handoff entries, snapshot entries) must be equal.  Times are not compared.

Tolerances: greedy and sampled token ids are compared exactly.  Both sides
run float32, where the frameworks' logits differ by sum order (~1e-6); each
test asserts that every emitted token's top-2 margin (of the logits, or of
the scaled logits plus the threefry Gumbel noise the sampler adds) clears
1e-4, so a near-tie cannot flake the equality.  The kernels phase's arms
agree within 2e-5 (float32 shapes) and 2e-2 (bf16 queries), the card's
tolerances; on the CPU the kernel and single arms are the plain version.
"""

import contextlib
import dataclasses
import io
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_device_plugin_tpu.models import benchmark as jbench
from k8s_device_plugin_tpu.models import transformer as jtf
from k8s_device_plugin_tpu.models.engine import ServingEngine as JaxEngine
from k8s_device_plugin_tpu_torch import convert
from k8s_device_plugin_tpu_torch.models import benchmark as tbench
from k8s_device_plugin_tpu_torch.models import transformer as ttf
from k8s_device_plugin_tpu_torch.utils import prng
from tools import bench_diff

SERVING = ["--model", "serving", "--tiny", "--router-replicas", "0", "--requests", "8",
           "--slots", "4", "--prompt-len", "16", "--decode-tokens", "48"]
PORT_CPU = ["--device=cpu", "--dtype=float32"]
NULL_BLOCKS = ("tp", "router", "fabric", "canary", "autoscale", "postmortem")
BLOCKS = ("overlap", "kvcache", "kernels", "overload", "restart", "elastic", "disagg", "slo",
          "trace", "profile")
MARGIN = 1e-4
TOL = {"f32": 2e-5, "bf16": 2e-2, "int8": 2e-2, "int4": 2e-2}


def _jax_main(argv) -> dict:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jbench.main(argv)
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _paged_geometry(args):
    mpp = math.ceil((args.prompt_len + args.decode_tokens) / 16)
    return dict(page_size=16, num_pages=args.slots * mpp + 1, max_pages_per_seq=mpp)


@pytest.fixture(scope="module")
def ref_params():
    """The reference run_serving's weights (tiny, float32)."""
    params = jtf.TransformerLM(jtf.GPTConfig.tiny()).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def jax_record():
    return _jax_main(SERVING)


@pytest.fixture(scope="module")
def port_run(ref_params):
    args = tbench.parse_args(SERVING + PORT_CPU)
    return args, tbench.run_serving(args, params=convert.flax_to_state_dict(ref_params))


def _keys(block, prefix=""):
    out = set()
    for key, value in block.items():
        out.add(prefix + key)
        if isinstance(value, dict) and key not in ("sheds_by_kind", "phase_ms_p50", "shapes"):
            out |= _keys(value, prefix + key + ".")
    return out


def test_serving_record_keys_equal_the_reference(jax_record, port_run):
    record = port_run[1].record
    assert list(record) == list(jax_record)
    for name in BLOCKS:
        assert isinstance(record[name], dict) and isinstance(jax_record[name], dict), name
        assert _keys(record[name]) == _keys(jax_record[name]), name
    assert list(record["kernels"]["shapes"]) == list(jax_record["kernels"]["shapes"])
    for shape, row in jax_record["kernels"]["shapes"].items():
        assert list(record["kernels"]["shapes"][shape]) == list(row), shape
    assert [k for k, v in record.items() if v is None] == list(NULL_BLOCKS)
    # The reference prints its autoscale block even without replicas.
    assert [k for k, v in jax_record.items() if v is None] == [
        k for k in NULL_BLOCKS if k != "autoscale"]


def test_serving_schedule_counts_equal_the_reference(jax_record, port_run):
    record = port_run[1].record
    for key in ("model", "slots", "requests", "prompt_len", "new_tokens"):
        assert record[key] == jax_record[key], key
    assert record["chips"] == 1  # one card (the reference counts its jax devices)
    # The KV-tier deltas taken right after their phases.  The cumulative
    # counters (overlap hits and discards, tier totals, spans) are read at
    # the end, after the overload storm, whose deadlines follow the
    # measured rate: they are not the schedule's alone.
    want, got = jax_record["kvcache"], record["kvcache"]
    for key in ("hits", "churn_tokens", "preemptions", "resumes_restored",
                "resumes_recomputed"):
        assert got[key] == want[key], key
    # Byte counts are not the schedule's: each entry's meta prints the CRC32
    # of its K/V rows in decimal, and the frameworks' rows part in the last
    # float32 bits.
    assert record["restart"]["snapshot_bytes"] > 0 and record["elastic"]["wire_bytes"] > 0
    for block, keys in (("restart", ("sessions", "prefix_tokens", "snapshot_entries",
                                     "entries_loaded")),
                        ("elastic", ("sessions", "prefix_tokens", "entries", "entries_restored")),
                        ("disagg", ("prefill_jobs", "long_prompt_tokens"))):
        for key in keys:
            assert record[block][key] == jax_record[block][key], (block, key)
    for block, sub in (("restart", "warm"), ("elastic", "warmed_join")):
        assert record[block][sub] | {"ttft_p50_ms": 0, "ttft_p99_ms": 0} == \
            jax_record[block][sub] | {"ttft_p50_ms": 0, "ttft_p99_ms": 0}
    for key in ("handoff_entries", "skipped_prefill_tokens", "tokens_match"):
        assert record["disagg"]["disagg"][key] == jax_record["disagg"]["disagg"][key], key
    assert record["disagg"]["disagg"]["tokens_match"] is True
    assert record["profile"]["steps"] == jax_record["profile"]["steps"]
    assert record["profile"]["occupancy"] == jax_record["profile"]["occupancy"]
    assert record["slo"]["burn_alert_fired"] is True
    assert record["slo"]["sli_verdicts"] == jax_record["slo"]["sli_verdicts"]


def test_serving_streams_equal_the_jax_engine(ref_params, port_run):
    args, run = port_run
    geo = _paged_geometry(args)
    cfg = dataclasses.replace(jtf.GPTConfig.tiny(),
                              max_seq=geo["page_size"] * geo["max_pages_per_seq"])
    jobs = [([(11 * i + j) % cfg.vocab_size for j in range(args.prompt_len)], args.decode_tokens)
            for i in range(args.requests)]
    eng = JaxEngine(cfg, ref_params, jtf.PagedConfig(**geo), max_slots=args.slots)
    want = [list(r.tokens) for r in eng.run(jobs)]
    got = [list(r.tokens) for r in run.done]
    assert got == want
    # Overlapped = synchronous = tracing on, within the port too.
    assert run.extras["sync_tokens"] == got == run.extras["trace_on_tokens"]
    # No emitted token is a near-tie in the port's full forward.
    tcfg = dataclasses.replace(ttf.GPTConfig.tiny(), max_seq=cfg.max_seq)
    model = ttf.TransformerLM(tcfg, device="cpu")
    model.load_state_dict(convert.flax_to_state_dict(ref_params))
    seqs = torch.tensor([p + t for (p, _), t in zip(jobs, got)])
    with torch.no_grad():
        logits = model(seqs[:, :-1])[:, args.prompt_len - 1:]
    top2 = logits.topk(2, dim=-1).values
    assert float((top2[..., 0] - top2[..., 1]).min()) > MARGIN
    assert logits.argmax(-1).tolist() == got


def test_serving_warmup_covers_every_dispatch_shape(port_run):
    graphs = port_run[1].extras["graphs"]
    assert graphs["warmup"] and graphs["timed"] == graphs["warmup"]


def test_kernels_phase_arms_agree(port_run):
    holds = port_run[1].extras["kernels"]
    rows = port_run[1].record["kernels"]["shapes"]
    assert set(holds) - {"launches"} == set(rows)
    for name, held in holds.items():
        if name == "launches":
            continue
        assert held["kernel_err"] <= TOL[held["fmt"]], name
        assert held["single_err"] <= TOL[held["fmt"]], name
        assert rows[name]["splits"] == 1  # the CPU row of ops/tuning.py
    # The plain versions launch no kernel.
    assert holds["launches"] == {"f": 0, "int8": 0, "int4": 0}


def test_bench_diff_reads_the_port_record(tmp_path, jax_record, port_run):
    """``tools/bench_diff.py`` fills from the port's record every field it
    fills from the reference's, once the blocks the port prints null are
    null in the reference's too."""
    ref = dict(jax_record, autoscale=None)
    paths = []
    for name, record in (("ref", ref), ("port", port_run[1].record)):
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps({"n": 1, "rc": 0, "parsed": record}))
        paths.append(str(path))
    want, got = (bench_diff.load_record(p) for p in paths)
    assert set(got) == set(want)
    assert {k for k, v in got.items() if v is None} == {k for k, v in want.items() if v is None}
    assert got["overlap_discards"] == port_run[1].record["overlap"]["discards"]


def test_serving_cli_prints_one_record(capsys):
    tbench.main(["--model", "serving", "--tiny", "--no-kernel", "--slots", "2",
                 "--requests", "4", "--prompt-len", "16", "--decode-tokens", "8", *PORT_CPU])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    record = json.loads(lines[0])
    assert record["model"] == "serving" and record["kernels"] is None
    assert record["disagg"] == {"skipped": "max_len 32 leaves no room for a long prompt"}
    assert record["requests"] == 4 and record["throughput"] > 0


# ------------------------------------------------------------- gpt-decode

DECODE = {
    "greedy": ["--model", "gpt-decode", "--tiny", "--batch-size", "2", "--prompt-len", "4",
               "--decode-tokens", "8"],
    "sampled": ["--model", "gpt-decode", "--tiny", "--batch-size", "2", "--prompt-len", "4",
                "--decode-tokens", "6", "--temperature", "0.8", "--top-k", "16"],
}


@pytest.mark.parametrize("mode", sorted(DECODE))
def test_gpt_decode_record_equals_the_reference(capsys, mode):
    want = _jax_main(DECODE[mode])
    tbench.main(DECODE[mode] + PORT_CPU)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert list(got) == list(want)
    for key in ("model", "sampler", "batch", "prompt_len", "new_tokens"):
        assert got[key] == want[key], key
    assert got["chips"] == 1 and got["throughput"] > 0 and got["ms_per_token"] > 0


@pytest.mark.parametrize("mode", sorted(DECODE))
def test_gpt_decode_streams_equal_jax_generate(ref_params, mode):
    args = tbench.parse_args(DECODE[mode] + PORT_CPU)
    state = convert.flax_to_state_dict(ref_params)
    record, tokens = tbench.run_decode(args, params=state)
    assert tokens.shape == (args.batch_size, args.prompt_len + args.decode_tokens)
    prompt = tokens[:, : args.prompt_len]
    jcfg = jtf.GPTConfig.tiny()
    if args.temperature is None:
        want = jtf.greedy_generate(jcfg, ref_params, jnp.asarray(prompt.numpy()),
                                   args.decode_tokens)
    else:
        want = jtf.sample_generate(jcfg, ref_params, jnp.asarray(prompt.numpy()),
                                   args.decode_tokens, rng=jax.random.PRNGKey(1),
                                   temperature=args.temperature, top_k=args.top_k)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want))
    # Margins of what each pick took the argmax of.
    model = ttf.TransformerLM(ttf.GPTConfig.tiny(), device="cpu")
    model.load_state_dict(state)
    with torch.no_grad():
        logits = model(tokens[:, :-1])[:, args.prompt_len - 1:]
    if args.temperature is not None:
        scaled = logits / args.temperature
        kth = scaled.topk(args.top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth, ttf.NEG_LOGIT, scaled)
        key = prng.PRNGKey(1)
        noise = torch.stack([prng.gumbel(prng.fold_in(key, args.prompt_len - 1 + i),
                                         scaled[:, i].shape)
                             for i in range(args.decode_tokens)], dim=1)
        logits = scaled + noise
    top2 = logits.topk(2, dim=-1).values
    assert float((top2[..., 0] - top2[..., 1]).min()) > MARGIN
    assert logits.argmax(-1).tolist() == tokens[:, args.prompt_len:].tolist()
