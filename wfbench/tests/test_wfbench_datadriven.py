"""A later change adds a configuration, a traffic mix and a metric as
files and entries, and the harness finds and runs them by name with no
existing file edited."""

import hashlib
import json
import time

from wfbench import harness


def digest(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest()
        for p in sorted(root.rglob("*")) if p.is_file()}


def test_new_files_and_entries_run_by_name(small, monkeypatch):
    before = digest(small)
    wf = small / "wfbench"
    conf = json.loads((wf / "configs" / "curve4096.json").read_text())
    conf.update(name="curve2048", streams=3)
    conf["settings"]["fft_size"] = 2048
    (wf / "configs" / "curve2048.json").write_text(json.dumps(conf))
    mix = json.loads((wf / "traffic" / "packets.json").read_text())
    mix["packet_frames"] = 480          # 10 ms packets: 1 or 2 a tick
    (wf / "traffic" / "packets10ms.json").write_text(json.dumps(mix))
    (wf / "metrics" / "wait_ms.py").write_text(
        "def read(run):\n    return float(run.wait_s.mean()) * 1e3\n")
    # a reader sees the peak and the adapter as well as the timings
    (wf / "metrics" / "peak_mem_mb.py").write_text(
        "def read(run):\n    assert run.adapter.S == 3\n"
        "    return run.peak_bytes / 2 ** 20\n")
    bench = json.loads((small / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "curve2048", "source": conf["source"],
        "file": "wfbench/configs/curve2048.json", "reduced": [],
        "why": "a smaller FFT"})
    bench["workloads"].append({
        "name": "curve2048.s3.packets10ms", "config": "curve2048",
        "traffic": "packets10ms", "chips": 1, "why": "10 ms packets"})
    bench["per_layer"].append({
        "name": "wait_ms", "unit": "ms", "better": "lower",
        "source": "host_clock", "layer": "device", "moves": "frames_per_s"})
    bench["per_layer"].append({
        "name": "peak_mem_mb", "unit": "MB", "better": "lower",
        "source": "device_trace", "layer": "device", "moves": "frames_per_s"})
    (small / "BENCHMARK.json").write_text(json.dumps(bench))

    monkeypatch.setattr(harness, "PROFILED_TICKS", 3)
    r = harness.run_cell("curve2048.s3.packets10ms", 99, 0.3, True, "cpu",
                         time.perf_counter(), log=lambda line: None,
                         root=small)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"ingest_ms", "tick_host_ms", "wait_ms",
                                 "peak_mem_mb"}
    after = digest(small)
    changed = {k for k in before if before[k] != after.get(k)}
    assert changed == {"BENCHMARK.json"}
    assert set(after) - set(before) >= {
        "wfbench/configs/curve2048.json", "wfbench/traffic/packets10ms.json",
        "wfbench/metrics/wait_ms.py", "wfbench/metrics/peak_mem_mb.py"}
