"""skix_torch's image_edit CLI against skix's, on the CPU at a tiny width.

One twin of the CLI over a tiny YAML config of the default path
(``text_tower: qwen_vl`` conditioned on the frame, the KL-VAE, a fused
LoRA, true-CFG at 2, the DiT at head dim 128) and a synthetic clip of two
80 × 60 frames (both resizes downsample: jax's antialiased bilinear), with
a second clip whose decode fails in both CLIs (its summary entry −1). The
weights are seeded numpy draws written as skix checkpoint npz files that
both CLIs load; the initial noise of the port's edits is patched to skix's
``jax.random`` draw. skix's programs compile at XLA's optimization level 0
(``_torch_parity._CHEAP``).

Compared: the decoded float image of every edit before quantization (1e-4
of the largest element where that exceeds 1), the PNGs (within 1 grey
level) and the summary (equal).
"""

import functools
import json

import cv2
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from _torch_parity import (_CHEAP, close_scaled, jit0, port_variables,
                           random_variables, run_stage_twins)

from skix.models import qwen_text as ST
from skix.models import qwen_vl as SV
from skix.pipelines import image_edit as SI
from skix.pipelines.videopose3d import save_checkpoint
from skix_torch.io.video import write_video
from skix_torch.models import mmdit as PM
from skix_torch.models import vae as PVAE
from skix_torch.pipelines import image_edit as PI

TEXT_DIM, VOCAB = 64, 49408 + 3
BODY = """
paths:
  video_root: {root}/videos
  out_root: {{out}}
checkpoint: {root}/dit.npz
text_encoder_checkpoint: {root}/vl.npz
vae_checkpoint: {root}/vae.npz
lora_path: {root}/lora.npz
lora_scale: 1.25
text_len: 8
text_tower: qwen_vl
text_encoder:
  layers: 1
  heads: 4
  kv_heads: 2
vision_encoder:
  depth: 2
  hidden: 32
  heads: 2
  intermediate: 64
image_tokens: 4
image_size: 32
latent_downsample: 8
dim: 256
depth: 2
num_heads: 2
axes_dim: [16, 56, 56]
text_dim: {dim}
num_inference_steps: 2
sampler: edit_plus
true_cfg_scale: 2.0
use_vae: true
vae_ch: 8
latent_channels: 16
frame_stride: 1
max_frames: 2
edits:
  - rotate_deg: 30.0
  - wideangle: true
"""


def _write_inputs(root):
    rng = np.random.default_rng(77)
    dit = PM.QwenImageDiT(in_channels=64, out_channels=16, num_layers=2,
                          attention_head_dim=128, num_attention_heads=2,
                          joint_attention_dim=TEXT_DIM,
                          axes_dims_rope=(16, 56, 56))
    save_checkpoint(str(root / "dit.npz"), port_variables(dit, 1))
    save_checkpoint(str(root / "vae.npz"), port_variables(
        PVAE.KLVAE(ch=8, latent_channels=16), 2))

    def near_one(v):
        return jax.tree_util.tree_map_with_path(
            lambda p, a: (1.0 + 0.05 * rng.normal(size=a.shape)).astype(
                np.float32) if p[-1].key == "weight" else a, v)

    text = ST.QwenTextEncoder(vocab_size=VOCAB, hidden=TEXT_DIM, layers=1,
                              heads=4, kv_heads=2, intermediate=4 * TEXT_DIM)
    vision = SV.QwenVisionTower(depth=2, hidden=32, heads=2, intermediate=64,
                                out_hidden=TEXT_DIM,
                                fullatt_block_indexes=(1,))
    save_checkpoint(str(root / "vl.npz"), {
        "text": near_one(random_variables(text, rng,
                                          jnp.zeros((1, 8), jnp.int32))),
        "vision": near_one(random_variables(
            vision, rng, jnp.zeros((16, 1176)), grid_thw=((1, 4, 4),)))})
    r = 2
    np.savez(root / "lora.npz", **{
        "blocks_0.to_q.lora_A.weight": rng.normal(size=(r, 256)),
        "blocks_0.to_q.lora_B.weight": 0.1 * rng.normal(size=(256, r)),
        "blocks_1.img_mlp_in.lora.down.weight": rng.normal(size=(r, 256)),
        "blocks_1.img_mlp_in.lora.up.weight": 0.1 * rng.normal(
            size=(1024, r)),
        "blocks_1.img_mlp_in.alpha": np.asarray(4.0)})
    yy, xx = np.mgrid[0:60, 0:80].astype(np.float32)
    frames = np.stack([np.stack([128 + 100 * np.sin(xx / 9 + t),
                                 128 + 90 * np.cos(yy / 7 - t),
                                 (xx + 2 * yy + 40 * t) % 256], -1)
                       for t in range(3)]).astype(np.uint8)
    write_video(root / "videos" / "p01" / "clip.mp4", frames)
    write_video(root / "videos" / "p01" / "broken.mp4", frames[:1])


def _failing_read(read):
    @functools.wraps(read)
    def wrapped(path, *a, **kw):
        if "broken" in str(path):
            raise OSError(f"cannot decode {path}")
        return read(path, *a, **kw)
    return wrapped


def test_cli_matches_skix(tmp_path, monkeypatch):
    import skix.io.video
    import skix_torch.io.video

    _write_inputs(tmp_path)
    floats = {"skix": [], "port": []}

    # skix: compiled cheaply, its decodes recorded before quantization
    orig_jit = jax.jit
    monkeypatch.setattr(jax, "jit", functools.partial(
        orig_jit, compiler_options=_CHEAP))
    monkeypatch.setattr(SV, "_encode_core_mm", orig_jit(
        SV._encode_core_mm.__wrapped__, static_argnums=(0, 1, 2, 3),
        compiler_options=_CHEAP))
    init = SI.CameraEditor.__init__

    def recording_init(self, cfg):
        init(self, cfg)
        decode = self._decode

        def rec(v, z):
            out = decode(v, z)
            floats["skix"].append(np.asarray(out[0]))
            return out
        self._decode = rec

    monkeypatch.setattr(SI.CameraEditor, "__init__", recording_init)
    # the port: skix's noise, its decodes recorded
    monkeypatch.setattr(PI, "initial_noise", lambda shape, seed, device:
                        PI.torch.as_tensor(np.array(jax.random.normal(
                            jax.random.PRNGKey(seed), tuple(shape),
                            jnp.float32))).to(device))
    decode = PI.CameraEditor.decode

    def rec_port(self, z):
        out = decode(self, z)
        floats["port"].append(out.numpy())
        return out

    monkeypatch.setattr(PI.CameraEditor, "decode", rec_port)
    for mod in (skix.io.video, skix_torch.io.video):
        monkeypatch.setattr(mod, "read_video", _failing_read(mod.read_video))

    body = BODY.format(root=tmp_path, dim=TEXT_DIM)
    want_dir, got_dir = run_stage_twins(tmp_path, "image_edit", body,
                                        SI.main, PI.main)
    assert len(floats["port"]) == len(floats["skix"]) == 4
    for got, want in zip(floats["port"], floats["skix"]):
        assert got.shape == want.shape == (32, 32, 3)
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)
    summary = json.loads((got_dir / "image_edit_summary.json").read_text())
    assert summary == json.loads(
        (want_dir / "image_edit_summary.json").read_text())
    assert summary == {"p01/broken": -1, "p01/clip": 4}
    pngs = sorted(p.relative_to(want_dir) for p in want_dir.rglob("*.png"))
    assert pngs == sorted(p.relative_to(got_dir)
                          for p in got_dir.rglob("*.png"))
    assert len(pngs) == 4
    for rel in pngs:
        a = cv2.imread(str(want_dir / rel)).astype(int)
        b = cv2.imread(str(got_dir / rel)).astype(int)
        assert np.abs(a - b).max() <= 1, rel
    # the edits differ from one another: the prompt and frame reach them
    assert not np.allclose(floats["port"][0], floats["port"][1])


def test_cpu_is_asked_for():
    if PI.torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PI.CameraEditor({"use_vae": False})


@pytest.mark.parametrize("tower", ["qwen", "clip", "smoke_text"])
def test_prompt_towers_match_skix(tmp_path, tower):
    """The editor's other prompt towers (text_tower qwen, clip, and the
    hash embedding of smoke_text) against skix's towers on the same ids
    and weights (1e-4 of the largest element where that exceeds 1); the
    pixel-space SDEdit edit of such an editor has the frame's shape."""
    from skix.models.mmdit import embed_prompt_tokens
    from skix.tracking.clip_text import VETextEncoder
    from skix.tracking.clip_tokenizer import ClipTokenizer

    rng = np.random.default_rng(5)
    cfg = {"text_tower": tower, "text_len": 8, "text_dim": TEXT_DIM,
           "dim": 64, "num_heads": 2, "depth": 1, "axes_dim": [8, 12, 12],
           "image_size": 32, "use_vae": False, "sampler": "sdedit",
           "num_inference_steps": 1, "device": "cpu"}
    ids = ClipTokenizer(context_length=8)(["tilt the camera"])
    if tower == "qwen":
        skix_tower = ST.QwenTextEncoder(vocab_size=49408, hidden=TEXT_DIM,
                                        layers=1, heads=4, kv_heads=2,
                                        intermediate=4 * TEXT_DIM)
        cfg["text_encoder"] = {"layers": 1}
        want_of = lambda v: skix_tower.apply(v, ids)[0]  # noqa: E731
    elif tower == "clip":
        skix_tower = VETextEncoder(d_model=TEXT_DIM, width=32, heads=2,
                                   layers=1, context_length=8)
        cfg["text_encoder"] = {"width": 32, "heads": 2, "layers": 1}
        want_of = lambda v: skix_tower.apply(v, ids)[1][0]  # noqa: E731
    if tower != "smoke_text":
        v = jax.tree_util.tree_map_with_path(
            lambda p, a: (1.0 + 0.05 * rng.normal(size=a.shape)).astype(
                np.float32) if p[-1].key == "weight" else a,
            random_variables(skix_tower, rng, jnp.zeros((1, 8), jnp.int32)))
        save_checkpoint(str(tmp_path / "text.npz"), v)
        cfg["text_encoder_checkpoint"] = str(tmp_path / "text.npz")
        want = jit0(want_of)(v)
    else:
        cfg["smoke_text"] = True
        want = embed_prompt_tokens("tilt the camera", 8, TEXT_DIM)
    editor = PI.CameraEditor(cfg)
    close_scaled(editor.embed_prompt("tilt the camera").numpy(), want, 1e-4)
    out, prompt = editor.infer_camera_edit(
        np.full((40, 56, 3), 90, np.uint8), vertical_tilt=1.0)
    assert out.shape == (32, 32, 3) and out.dtype == np.uint8
    assert prompt == "Tilt the camera upward 镜头上仰"
