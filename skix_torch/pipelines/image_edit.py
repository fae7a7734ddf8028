"""Stage CLI: novel-camera-angle frame synthesis (image editing).

Port of ``skix/pipelines/image_edit.py`` over the same
``configs/image_edit.yaml``. :class:`CameraEditor` builds the bilingual
camera-motion prompt of each edit (rotate_deg, move_forward,
vertical_tilt, wideangle), embeds it with the text tower (``text_tower``:
``qwen_vl``, the default, conditions the prompt on the frame's vision
tokens; ``qwen`` the text-only Qwen2 tower; ``clip`` the VE/CLIP tower;
``smoke_text: true`` the hash embedding), encodes the frame (resized to
``image_size`` with jax's antialiased bilinear) with the KL-VAE
(``use_vae``; else a pixel downsample), and runs the Qwen-Image MMDiT's
Edit-Plus loop (``sampler: edit_plus``, true-CFG above ``true_cfg_scale``
1) or the SDEdit option (``sampler: sdedit``), then decodes and
quantizes as ``clip((out + 1)·127.5).astype(uint8)``. LoRA adapters
(``lora_path``, a safetensors-shaped npz) fuse into the denoiser at
``lora_scale``.

Every joint attention of the denoiser goes through
``skix_torch.ops.attention.flash_attention`` with the interleaved rope:
K1 on the card, its plain version on the CPU. The text and vision towers'
attention is plain torch, as it is plain XLA in skix.

Weights: ``checkpoint`` (a skix npz, or a ``.pt/.pth`` state dict of the
vendored diffusers transformer through
``mmdit.convert_qwen_image_transformer``), ``text_encoder_checkpoint`` (a
skix npz; a ``.pt/.pth`` HF state dict through ``convert_hf_qwen2_5_vl``,
``convert_hf_qwen2`` or ``convert_ve_text_encoder`` by tower),
``vae_checkpoint`` (a skix npz); without them the models run, loudly,
with seeded random weights (skix's smoke mode). The Qwen tokenizer loads
``qwen_vocab``/``qwen_merges``; without them the in-repo CLIP BPE stands
in, as in skix.

The initial noise of each edit comes from a CPU ``torch.Generator``
seeded with the edit's seed (skix draws it from ``jax.random``, whose
stream torch cannot reproduce): :func:`initial_noise`, moved to the
device, so the card and the CPU start from the same noise.

Outputs, as skix writes them: ``<out_root>/<person>/<video>/
frame_XXXXXX_editN.png`` and ``<out_root>/image_edit_summary.json``
(edited frames per video, −1 for a video that failed: per-video errors
are logged and swallowed). Runs on ``cfg.device`` (default ``cuda``).
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from skix_torch.config import cli_main, iter_person_dirs
from skix_torch.convert import flax_to_state_dict, load_flat_npz, load_into
from skix_torch.utils.device import resolve_device
from skix_torch.utils.image import resize

log = logging.getLogger(__name__)

_TORCH_SUFFIXES = (".pt", ".pth")


def initial_noise(shape, seed: int, device) -> torch.Tensor:
    """Standard-normal float32 noise of ``shape`` from a CPU generator
    seeded ``seed``, on ``device``."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randn(tuple(shape), generator=gen).to(device)


def _exists(path) -> bool:
    return bool(path) and Path(path).exists()


def _torch_state(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _seeded(module, seed: int, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return module.init_weights(gen)


class CameraEditor:
    def __init__(self, cfg):
        from skix_torch.models.mmdit import QwenImageDiT

        self.cfg = cfg
        self.device = dev = resolve_device(cfg.get("device", "cuda"))
        self.latent_down = int(cfg.get("latent_downsample", 8))
        self.use_vae = bool(cfg.get("use_vae", False))
        self.latent_channels = (int(cfg.get("latent_channels", 16))
                                if self.use_vae else 3)
        dim = int(cfg.get("dim", 256))
        heads = int(cfg.get("num_heads", 4))
        with dev:
            self.model = QwenImageDiT(
                patch_size=2, in_channels=4 * self.latent_channels,
                out_channels=self.latent_channels,
                num_layers=int(cfg.get("depth", 4)),
                attention_head_dim=dim // heads, num_attention_heads=heads,
                joint_attention_dim=int(cfg.get("text_dim", 64)),
                axes_dims_rope=tuple(cfg.get("axes_dim", (16, 24, 24))))
        size = self.size = int(cfg.get("image_size", 512))
        lat = size // self.latent_down
        if lat % 2:
            raise ValueError(f"latent grid {lat} must be even for 2×2 "
                             "token packing")
        # token grids (target, source): the pipeline's img_shapes
        self._fhw = ((1, lat // 2, lat // 2), (1, lat // 2, lat // 2))
        self.true_cfg = float(cfg.get("true_cfg_scale", 1.0))
        self.negative_prompt = str(cfg.get("negative_prompt", " "))
        self.sampler = str(cfg.get("sampler", "edit_plus"))
        ckpt = cfg.get("checkpoint")
        if _exists(ckpt):
            if str(ckpt).endswith(_TORCH_SUFFIXES):
                from skix_torch.models.mmdit import (
                    convert_qwen_image_transformer)

                sd = convert_qwen_image_transformer(_torch_state(ckpt))
                log.info("converted reference QwenImage transformer from %s",
                         ckpt)
            else:
                sd = flax_to_state_dict(ckpt)
            load_into(self.model, sd)
        else:
            log.warning("no image-edit checkpoint configured — random init "
                        "(smoke mode)")
            _seeded(self.model, 0, dev)
        self.model.eval()

        # text conditioning: tokenizer → text tower → MMDiT (the hash
        # embedding is smoke-only and must be asked for explicitly)
        self.text_len = int(cfg.get("text_len", 16))
        self.text_encoder = None
        self.text_tower = str(cfg.get("text_tower", "qwen"))
        self._prompt_cache: dict = {}
        if bool(cfg.get("smoke_text", False)):
            log.warning("smoke_text=true: prompts use the deterministic "
                        "HASH embedding, not a text encoder — edits are "
                        "not semantically conditioned")
        elif self.text_tower == "qwen_vl":
            self._build_qwen_vl_tower(cfg)
        elif self.text_tower == "qwen":
            self._build_qwen_tower(cfg)
        else:
            self._build_clip_tower(cfg)

        # LoRA adapters fused into the denoiser (the reference's
        # multiple-angles LoRA at scale 1.25)
        lora_path = cfg.get("lora_path")
        if _exists(lora_path):
            from skix_torch.models.lora import (apply_lora,
                                                convert_safetensors_lora)

            with np.load(lora_path, allow_pickle=False) as z:
                lora = convert_safetensors_lora({k: z[k] for k in z.files})
            n = apply_lora(self.model, lora,
                           scale=float(cfg.get("lora_scale", 1.25)))
            log.info("fused %d LoRA deltas from %s", n, lora_path)

        self.vae = None
        if self.use_vae:
            from skix_torch.models.vae import KLVAE

            with dev:
                self.vae = KLVAE(ch=int(cfg.get("vae_ch", 32)),
                                 latent_channels=self.latent_channels)
            vae_ckpt = cfg.get("vae_checkpoint")
            if _exists(vae_ckpt):
                load_into(self.vae, flax_to_state_dict(vae_ckpt))
            else:
                log.warning("no VAE checkpoint — random init (smoke mode)")
                _seeded(self.vae, 1, dev)
            self.vae.eval()

    # -- towers --------------------------------------------------------------
    def _resolve_qwen_tokenizer(self, cfg, vl: bool):
        """The real byte-level BPE when ``qwen_vocab``/``qwen_merges`` are
        there, else the in-repo CLIP BPE (ids only); returns (vocab_size,
        (vision_start, vision_end, image_pad) ids)."""
        vocab, merges = cfg.get("qwen_vocab"), cfg.get("qwen_merges")
        if _exists(vocab) and _exists(merges):
            from skix_torch.models.qwen_text import QwenBpeTokenizer

            self.tokenizer = QwenBpeTokenizer(vocab, merges,
                                              context_length=self.text_len)
            vocab_size = max(self.tokenizer.encoder.values()) + 1
            if vl:    # the real vision special ids lie above the BPE table
                vocab_size = max(vocab_size, 151656)
            return vocab_size, (151652, 151653, 151655)
        from skix_torch.tracking.clip_tokenizer import ClipTokenizer

        log.warning("no qwen_vocab/qwen_merges assets — tokenizing with the "
                    "in-repo CLIP BPE (the tower stays Qwen-shaped; drop in "
                    "the public vocab.json/merges.txt to match reference ids)")
        self.tokenizer = ClipTokenizer(context_length=self.text_len)
        return (49408 + 3 if vl else 49408), (49408, 49409, 49410)

    def _qwen_text_kwargs(self, cfg, vocab_size):
        te_kw = dict(cfg.get("text_encoder", {}) or {})
        te_kw.setdefault("layers", 2)
        te_kw.setdefault("heads", 4)
        te_kw.setdefault("kv_heads", 2)
        te_kw.setdefault("intermediate", 4 * int(cfg.get("text_dim", 64)))
        te_kw.setdefault("vocab_size", vocab_size)
        te_kw["vocab_size"] = int(te_kw["vocab_size"])
        te_kw["hidden"] = int(cfg.get("text_dim", 64))
        return te_kw

    def _build_qwen_tower(self, cfg):
        from skix_torch.models.qwen_text import (QwenTextEncoder,
                                                 convert_hf_qwen2)

        vocab_size, _ = self._resolve_qwen_tokenizer(cfg, vl=False)
        with self.device:
            enc = QwenTextEncoder(**self._qwen_text_kwargs(cfg, vocab_size))
        te_ckpt = cfg.get("text_encoder_checkpoint")
        if _exists(te_ckpt):
            load_into(enc, convert_hf_qwen2(_torch_state(te_ckpt))
                      if str(te_ckpt).endswith(_TORCH_SUFFIXES)
                      else flax_to_state_dict(te_ckpt))
        else:
            log.warning("no text-encoder checkpoint — random-init "
                        "Qwen-shaped tower (untrained weights); convert one "
                        "via convert_hf_qwen2")
            _seeded(enc, 2, self.device)
        self.text_encoder = enc.eval()

    def _build_clip_tower(self, cfg):
        from skix_torch.tracking.clip_text import (VETextEncoder,
                                                   convert_ve_text_encoder)
        from skix_torch.tracking.clip_tokenizer import ClipTokenizer

        te_kw = dict(cfg.get("text_encoder", {}) or {})
        te_kw.setdefault("width", 256)
        te_kw.setdefault("heads", 4)
        te_kw.setdefault("layers", 4)
        with self.device:
            enc = VETextEncoder(d_model=int(cfg.get("text_dim", 64)),
                                context_length=self.text_len, **te_kw)
        self.tokenizer = ClipTokenizer(context_length=self.text_len)
        te_ckpt = cfg.get("text_encoder_checkpoint")
        if _exists(te_ckpt):
            load_into(enc, convert_ve_text_encoder(_torch_state(te_ckpt))
                      if str(te_ckpt).endswith(_TORCH_SUFFIXES)
                      else flax_to_state_dict(te_ckpt))
        else:
            log.warning("no text-encoder checkpoint — random-init tower "
                        "(untrained weights); convert one via "
                        "convert_ve_text_encoder")
            _seeded(enc, 2, self.device)
        self.text_encoder = enc.eval()

    def _build_qwen_vl_tower(self, cfg):
        """The Qwen2.5-VL multimodal tower: the frame's vision tokens are
        spliced into the prompt and the text tower runs with the 3D rope.
        The vision special ids are the real Qwen ids with the real vocab,
        else the top of the stand-in vocab."""
        from skix_torch.models.qwen_text import QwenTextEncoder
        from skix_torch.models.qwen_vl import (QwenVisionTower, QwenVLEncoder,
                                               convert_hf_qwen2_5_vl)

        vocab_size, (vs_id, ve_id, pad_id) = \
            self._resolve_qwen_tokenizer(cfg, vl=True)
        dim = int(cfg.get("text_dim", 64))
        vi_kw = dict(cfg.get("vision_encoder", {}) or {})
        vi_kw.setdefault("depth", 2)
        vi_kw.setdefault("hidden", 32)
        vi_kw.setdefault("heads", 2)
        vi_kw.setdefault("intermediate", 64)
        vi_kw.setdefault("fullatt_block_indexes", (int(vi_kw["depth"]) - 1,))
        with self.device:
            text = QwenTextEncoder(**self._qwen_text_kwargs(cfg, vocab_size))
            vision = QwenVisionTower(out_hidden=dim, **vi_kw)
        half = dim // text.heads // 2
        sec = cfg.get("mrope_section")
        if sec is None:
            # HF 7B ratio [16, 24, 24] of half = 64 → (1/4, 3/8, 3/8)
            t = half // 4
            h = (half - t) // 2
            sec = (t, h, half - t - h)
        self._vl_image_tokens = int(cfg.get("image_tokens", 16))
        self._vl_patch = int(vi_kw.get("patch_size", 14))
        te_ckpt = cfg.get("text_encoder_checkpoint")
        if _exists(te_ckpt):
            if str(te_ckpt).endswith(_TORCH_SUFFIXES):
                sds = convert_hf_qwen2_5_vl(_torch_state(te_ckpt))
                log.info("converted HF Qwen2.5-VL tower from %s", te_ckpt)
            else:
                flat = load_flat_npz(te_ckpt)
                tops = {k.split("/", 1)[0] for k in flat}
                if not {"vision", "text"} <= tops:
                    raise ValueError(
                        f"VL checkpoint {te_ckpt} must hold a "
                        "{'vision': ..., 'text': ...} pytree")
                sds = {top: flax_to_state_dict(
                    {k.split("/", 1)[1]: v for k, v in flat.items()
                     if k.startswith(top + "/")})
                       for top in ("vision", "text")}
            load_into(vision, sds["vision"])
            load_into(text, sds["text"])
        else:
            log.warning("no VL checkpoint — random-init Qwen2.5-VL-shaped "
                        "tower (untrained weights); convert one via "
                        "convert_hf_qwen2_5_vl")
            _seeded(vision, 3, self.device)
            _seeded(text, 2, self.device)
        self.text_encoder = QwenVLEncoder(
            vision.eval(), text.eval(), mrope_section=sec,
            image_token_id=pad_id, vision_start_token_id=vs_id)
        self._vl_vision_end = ve_id

    # -- prompts -------------------------------------------------------------
    def _tokens(self, prompt: str):
        """The prompt's ``text_len`` ids and, from the Qwen tokenizer, its
        mask (None from the CLIP stand-in)."""
        toks = self.tokenizer([prompt])
        if isinstance(toks, tuple):            # QwenBpeTokenizer
            ids, mask = (np.asarray(t) for t in toks)
            return ids[0][:self.text_len], mask[0][:self.text_len]
        return np.asarray(toks)[0][:self.text_len], None

    @torch.no_grad()
    def _embed_prompt_vl(self, prompt: str, image=None) -> torch.Tensor:
        """``[vision_start, pad×N, vision_end] + text_ids`` with the
        image's vision tokens at the pads; the conditioning is the hidden
        states of the last ``text_len`` (text) positions."""
        from skix_torch.models.qwen_vl import preprocess_image_qwen

        enc = self.text_encoder
        text_ids, tmask = self._tokens(prompt)
        if image is not None:
            patches, grid = preprocess_image_qwen(
                image, patch_size=self._vl_patch,
                target_tokens=self._vl_image_tokens)
            n_real = (grid[1] // 2) * (grid[2] // 2)
            full = np.concatenate([
                [enc.vision_start_token_id],
                np.full(n_real, enc.image_token_id, np.int64),
                [self._vl_vision_end], text_ids]).astype(np.int64)
            mask = None
            if tmask is not None:              # the vision block is all real
                mask = np.concatenate(
                    [np.ones(n_real + 2, tmask.dtype), tmask])[None]
            hidden = enc.encode(full[None], patches, (grid,),
                                attention_mask=mask)
        else:
            hidden = enc.encode(
                text_ids[None].astype(np.int64),
                attention_mask=None if tmask is None else tmask[None])
        return hidden[0, -self.text_len:]

    @torch.no_grad()
    def embed_prompt(self, prompt: str) -> torch.Tensor:
        """Prompt → ``(text_len, text_dim)`` conditioning on the device,
        cached by prompt."""
        cached = self._prompt_cache.get(prompt)
        if cached is not None:
            return cached
        dev = self.device
        if self.text_encoder is None:   # explicit smoke_text=true
            from skix_torch.models.mmdit import embed_prompt_tokens

            emb = torch.as_tensor(embed_prompt_tokens(
                prompt, length=self.text_len,
                dim=int(self.cfg.get("text_dim", 64))), device=dev)
        elif self.text_tower == "qwen_vl":
            emb = self._embed_prompt_vl(prompt)
        elif self.text_tower == "qwen":
            ids, mask = self._tokens(prompt)
            emb = self.text_encoder(
                torch.as_tensor(ids[None], device=dev).long(),
                None if mask is None else torch.as_tensor(mask[None],
                                                          device=dev))[0]
        else:
            tokens = torch.as_tensor(np.asarray(self.tokenizer([prompt])),
                                     device=dev).long()
            _, resized, _ = self.text_encoder(tokens)
            emb = resized[0]
        self._prompt_cache[prompt] = emb
        return emb

    # -- one edit ------------------------------------------------------------
    @torch.no_grad()
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Unscaled latents ``(1, h, w, C)`` → the float image ``(size,
        size, 3)`` in about [−1, 1], before quantization."""
        if self.vae is not None:
            return self.vae.decode(z)[0]
        return resize(z[0], (self.size, self.size, 3), "bilinear")

    @torch.no_grad()
    def infer_camera_edit(self, frame_u8: np.ndarray, rotate_deg=0.0,
                          move_forward=0.0, vertical_tilt=0.0,
                          wideangle=False, seed: int = 0):
        from skix_torch.models.mmdit import (build_camera_prompt,
                                             edit_plus_sample,
                                             flow_matching_edit,
                                             pack_latents, unpack_latents)

        dev = self.device
        cfg = self.cfg
        prompt = build_camera_prompt(rotate_deg, move_forward, vertical_tilt,
                                     wideangle)
        frame = torch.as_tensor(np.asarray(frame_u8), device=dev)
        vl_on_image = (self.text_tower == "qwen_vl"
                       and self.text_encoder is not None
                       and bool(cfg.get("condition_on_image", True)))
        # the prompt tower sees the frame too: per frame, so no cache
        text = (self._embed_prompt_vl(prompt, frame) if vl_on_image
                else self.embed_prompt(prompt))
        neg = None
        if self.true_cfg > 1.0 and self.sampler != "sdedit":
            neg = (self._embed_prompt_vl(self.negative_prompt, frame)
                   if vl_on_image
                   else self.embed_prompt(self.negative_prompt))[None]
        img = frame.to(torch.float32) / 127.5 - 1.0
        if tuple(img.shape[:2]) != (self.size, self.size):
            img = resize(img, (self.size, self.size, 3), "bilinear")
        if self.vae is not None:
            mean, _ = self.vae.encode(img[None])
            lat = mean * self.vae.scaling_factor
        else:
            lat_size = self.size // self.latent_down
            lat = resize(img, (lat_size, lat_size, 3), "bilinear")[None]
        lat_h, lat_w = lat.shape[1], lat.shape[2]
        tokens = pack_latents(lat)
        steps = int(cfg.get("num_inference_steps", 4))
        noise = initial_noise(tokens.shape, seed, dev)
        if self.sampler == "sdedit":
            out_tok = flow_matching_edit(
                self.model, tokens, text[None], self._fhw[:1], noise,
                num_steps=steps, strength=float(cfg.get("strength", 0.6)))
        else:
            cond = bool(cfg.get("condition_on_latents", True))
            out_tok = edit_plus_sample(
                self.model, noise, tokens if cond else None, text[None],
                self._fhw if cond else self._fhw[:1],
                negative_prompt_emb=neg if self.true_cfg > 1.0 else None,
                true_cfg_scale=self.true_cfg, num_steps=steps)
        out_lat = unpack_latents(out_tok, lat_h, lat_w)
        if self.vae is not None:
            out_lat = out_lat / self.vae.scaling_factor
        out = self.decode(out_lat)
        out = torch.clamp((out + 1.0) * 127.5, 0, 255).to(torch.uint8)
        return out.cpu().numpy(), prompt


class ImageEditRun(NamedTuple):
    editor: CameraEditor   # the models, for further edits
    report: dict           # what image_edit_summary.json holds


@cli_main("image_edit")
def main(cfg) -> ImageEditRun:
    logging.basicConfig(level=logging.INFO)
    import cv2

    from skix_torch.io.video import read_video

    editor = CameraEditor(cfg)
    root = Path(cfg.paths.video_root)
    out_root = Path(cfg.paths.out_root)
    edits = cfg.get("edits", [{"rotate_deg": 30.0}, {"rotate_deg": -30.0}])
    stride = int(cfg.get("frame_stride", 30))
    report = {}
    for person_dir in iter_person_dirs(root, cfg):
        for video in sorted(person_dir.glob("*.mp4")):
            # per-video isolation: one corrupt video (or a bad edits key)
            # must not abort the batch and lose the summary
            key = f"{person_dir.name}/{video.stem}"
            try:
                frames = read_video(video, max_frames=cfg.get("max_frames"))
                out_dir = out_root / person_dir.name / video.stem
                out_dir.mkdir(parents=True, exist_ok=True)
                n = 0
                for t in range(0, len(frames), stride):
                    for e_i, edit in enumerate(edits):
                        ed = (edit.to_dict() if hasattr(edit, "to_dict")
                              else dict(edit))
                        out, _ = editor.infer_camera_edit(frames[t], **ed)
                        cv2.imwrite(
                            str(out_dir / f"frame_{t:06d}_edit{e_i}.png"),
                            cv2.cvtColor(out, cv2.COLOR_RGB2BGR))
                        n += 1
                report[key] = n
                log.info("%s: %d edited frames", key, n)
            except Exception:  # noqa: BLE001 — per-video isolation
                log.exception("%s failed", video)
                report[key] = -1
    out_root.mkdir(parents=True, exist_ok=True)
    (out_root / "image_edit_summary.json").write_text(
        json.dumps(report, indent=2))
    return ImageEditRun(editor, report)


if __name__ == "__main__":
    main()
