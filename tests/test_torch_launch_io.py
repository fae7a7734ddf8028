"""skix_torch's host-side IO and launch modules against skix on the CPU:
``PrefetchIterator`` and ``device_prefetch`` (values and order equal; the
card path raises without a card), the launcher (``shard_work``, and
``main`` under SKIX_FAKE_RENDEZVOUS running a stage over exactly skix's
share), one two-process gloo rendezvous over localhost, the subject map,
the COCO export and the metric logger (equal)."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch


def test_prefetch():
    from skix.io.prefetch import device_prefetch as s_prefetch
    from skix_torch.io.prefetch import PrefetchIterator, device_prefetch

    assert list(PrefetchIterator(range(20), depth=3)) == list(range(20))

    def broken():
        yield 1
        raise RuntimeError("decode failed")

    it = PrefetchIterator(broken())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)
    early = PrefetchIterator(range(10 ** 6), depth=2)
    assert next(early) == 0
    early.close()

    chunks = [np.random.default_rng(i).normal(size=(3, 4)).astype(np.float32)
              for i in range(6)]
    want = [np.asarray(x) for x in s_prefetch(chunks, transform=np.sqrt)]
    got = list(device_prefetch(chunks, transform=np.sqrt, device="cpu"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), w)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            device_prefetch(chunks)


def _fused_persons(root, n):
    rng = np.random.default_rng(41)
    for i in range(n):
        d = root / f"p{i:02d}"
        d.mkdir(parents=True)
        np.save(d / f"p{i:02d}_smoothed.npy",
                rng.normal(size=(8, 70, 3)).astype(np.float32))


def test_launch_shards_like_skix(tmp_path, monkeypatch):
    """``shard_work`` and ``main`` under SKIX_FAKE_RENDEZVOUS: each process
    runs the metrics stage over exactly skix's share of the persons, with
    skix's numbers."""
    from skix.utils import launch as slaunch
    from skix_torch.utils import launch as tlaunch

    items = [f"p{i:02d}" for i in range(11)] + [3, 1]
    for n in (1, 2, 3):
        for pid in range(n):
            assert tlaunch.shard_work(items, pid, n) == slaunch.shard_work(
                items, pid, n)
    # n_devices: the cards here (1 without), where skix counts jax's devices
    want = slaunch.initialize_distributed()
    got = tlaunch.initialize_distributed()
    assert got.pop("n_devices") == got.pop("n_local_devices") == 1
    assert got == {k: want[k] for k in ("process_id", "num_processes")}
    fused = tmp_path / "fused"
    _fused_persons(fused, 3)
    monkeypatch.setenv("SKIX_NUM_PROCESSES", "2")
    monkeypatch.setenv("SKIX_COORDINATOR", "localhost:0")
    monkeypatch.setenv("SKIX_FAKE_RENDEZVOUS", "1")
    for pid in range(2):
        monkeypatch.setenv("SKIX_PROCESS_ID", str(pid))
        reports = {}
        for side, mod in (("skix", slaunch), ("port", tlaunch)):
            out = tmp_path / f"{side}{pid}"
            mod.main(["metrics", f"--shard-root={fused}",
                      f"paths.in_root={fused}", f"paths.out_root={out}",
                      "device=cpu"])
            reports[side] = json.loads(
                (out / "metrics_report.json").read_text())
        share = slaunch.shard_work(["p00", "p01", "p02"], pid, 2)
        assert sorted(reports["port"]) == sorted(reports["skix"]) == share
        for person, r in reports["skix"].items():
            for key, v in r.items():
                for k2, x in (v.items() if isinstance(v, dict) else
                              [("", v)]):
                    np.testing.assert_allclose(
                        (reports["port"][person][key][k2] if k2 else
                         reports["port"][person][key]), x, rtol=1e-5,
                        err_msg=f"{person}/{key}/{k2}")


_CHILD = """
import os, sys, torch
import torch.distributed as dist
from skix_torch.utils.launch import initialize_distributed
info = initialize_distributed()
t = torch.tensor([int(os.environ["SKIX_PROCESS_ID"]) + 1.0])
dist.all_reduce(t)
dist.destroy_process_group()
print(info["process_id"], info["num_processes"], float(t))
"""


def test_gloo_rendezvous_two_processes():
    """Two processes meet at a TCP coordinator on localhost through
    ``initialize_distributed`` and sum one number."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = Path(__file__).resolve().parent.parent
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD], cwd=root, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=dict(os.environ, PYTHONPATH=str(root),
                 SKIX_COORDINATOR=f"localhost:{port}",
                 SKIX_NUM_PROCESSES="2", SKIX_PROCESS_ID=str(rank)))
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err
            outs.append(out.split())
    finally:
        for p in procs:
            p.kill()
    assert outs == [["0", "2", "3.0"], ["1", "2", "3.0"]]


def test_subject_map(tmp_path):
    from skix.io.subjects import build_subject_map as s_build
    from skix_torch.io.subjects import build_subject_map as t_build

    for mod, persons in (("pt", ["p01", "p02", "p03"]),
                         ("vggt", ["p01", "p03"]), ("sam3d", ["p03", "p04"])):
        for p in persons:
            (tmp_path / mod / p).mkdir(parents=True)
    roots = {m: tmp_path / m for m in ("pt", "vggt", "sam3d", "absent")}
    for require_all in (True, False):
        want = s_build(roots, require_all=require_all)
        got = t_build(roots, require_all=require_all)
        assert list(got) == list(want)
        assert all(got[k].paths == want[k].paths for k in want)


def test_coco_export(tmp_path):
    from skix.io import coco_export as scoco
    from skix_torch.io import coco_export as tcoco

    rng = np.random.default_rng(9)
    masks = rng.random((4, 13, 9)) > 0.6
    masks[1] = True
    boxes = rng.uniform(0, 50, (4, 4)).cumsum(-1)
    scores = np.array([0.9, 0.05, 0.5, 0.7])
    kw = dict(image_id=7, category_id=2, masks=masks,
              valid=np.array([1, 1, 0, 1], bool), score_threshold=0.1)
    want = scoco.detections_to_coco(boxes, scores, **kw)
    assert tcoco.detections_to_coco(boxes, scores, **kw) == want
    for m in masks:
        assert tcoco.mask_to_rle(m) == scoco.mask_to_rle(m)
        np.testing.assert_array_equal(tcoco.rle_to_mask(scoco.mask_to_rle(m)),
                                      m)
    tcoco.write_coco_results(tmp_path / "port.json", want)
    scoco.write_coco_results(tmp_path / "skix.json", want)
    assert ((tmp_path / "port.json").read_bytes()
            == (tmp_path / "skix.json").read_bytes())


def test_metric_logger(tmp_path):
    from skix.utils.metric_logger import MetricLogger as SLogger
    from skix.utils.metric_logger import read_metrics as s_read
    from skix_torch.utils.metric_logger import MetricLogger, read_metrics

    for cls, d in ((SLogger, "skix"), (MetricLogger, "port")):
        with cls(tmp_path / d) as log:
            log.log(1, loss=0.5, lr=np.float32(1e-3))
            log.log(2, loss=0.25)
    strip = [{k: v for k, v in r.items() if k != "time"}
             for r in s_read(tmp_path / "skix")]
    assert [{k: v for k, v in r.items() if k != "time"}
            for r in read_metrics(tmp_path / "port")] == strip
    assert read_metrics(tmp_path / "none") == s_read(tmp_path / "none") == []
