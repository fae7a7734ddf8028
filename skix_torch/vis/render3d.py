"""Offscreen 3D BEV renderer: a z-buffered software rasterizer in torch.

Port of ``skix/vis/render3d.py``: a lit ground slab, a skeleton line set
and keypoint spheres under a bird's-eye look-at camera, streamed to an
mp4, with no GL context. :func:`render_frame` runs on the tensors'
device (the card unless the caller works on the CPU):

- triangles in chunks of ``chunk``: every (triangle, pixel) pair of a
  chunk is tested with edge functions; the chunk's nearest triangle
  (``argmin``, the lowest index on a tie) replaces a pixel whose depth it
  beats strictly (``zmin < depth``), chunk after chunk in order, as skix's
  ``lax.scan`` carries its buffers. skix pads the last chunk with invalid
  triangles, whose infinite depth wins no pixel; the port leaves them out
  (the ground slab alone is 12 triangles of a 64-triangle chunk). Depth is
  perspective-correct (screen-linear 1/z), shading flat Lambert per face,
  both windings front;
- thick lines as screen-space distance-to-segment tests, z-tested against
  the triangle pass with a small bias;
- keypoints as sphere impostors (screen circles with a depth bulge) or,
  with ``kp_mode="mesh"``, as icosphere triangles.

skix tests every line and sphere against every pixel of the frame; the
port tests them on the window of pixels their screen boxes can reach
(:func:`_window`), outside which they cover nothing, so the frames are
the same.

Mesh builders and the camera are numpy on the host.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

# COCO-ish skeleton edge set
COCO_EDGES: Tuple[Tuple[int, int], ...] = (
    (5, 7), (7, 9), (6, 8), (8, 10), (5, 6), (5, 11), (6, 12),
    (11, 13), (13, 15), (12, 14), (14, 16), (11, 12),
)


# --------------------------------------------------------------------------
# host-side mesh builders (static scene assembly, numpy)
# --------------------------------------------------------------------------
def make_box(extent: Sequence[float],
             origin: Sequence[float] = (0.0, 0.0, 0.0)):
    """Axis-aligned box with its min corner at ``origin`` and sides
    ``extent``: (verts (8, 3), tris (12, 3))."""
    ex, ey, ez = [float(v) for v in extent]
    ox, oy, oz = [float(v) for v in origin]
    corners = np.array([[x, y, z] for x in (0, ex) for y in (0, ey)
                        for z in (0, ez)], np.float32)
    corners += np.array([ox, oy, oz], np.float32)
    # index layout: bit2=x, bit1=y, bit0=z
    quads = [(0, 1, 3, 2), (4, 6, 7, 5),   # x- / x+
             (0, 4, 5, 1), (2, 3, 7, 6),   # y- / y+
             (0, 2, 6, 4), (1, 5, 7, 3)]   # z- / z+
    tris = []
    for a, b, c, d in quads:
        tris.append((a, b, c))
        tris.append((a, c, d))
    return corners, np.asarray(tris, np.int32)


def make_icosphere(radius: float = 1.0, subdiv: int = 1):
    """Icosahedron subdivided ``subdiv`` times and normalized to ``radius``
    (20·4**subdiv triangles)."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array([
        [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
        [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
        [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
    ], np.float32)
    f = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int32)
    verts = [tuple(x) for x in (v / np.linalg.norm(v, axis=1, keepdims=True))]
    faces = [tuple(x) for x in f]
    for _ in range(subdiv):
        cache: dict = {}
        new_faces = []

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                m = np.asarray(verts[i]) + np.asarray(verts[j])
                m = m / np.linalg.norm(m)
                cache[key] = len(verts)
                verts.append(tuple(m))
            return cache[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc),
                          (ab, bc, ca)]
        faces = new_faces
    return (np.asarray(verts, np.float32) * float(radius),
            np.asarray(faces, np.int32))


def flatten_mesh(verts: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """(V, 3) + (N, 3) indices → per-triangle vertex array (N, 3, 3)."""
    return np.asarray(verts, np.float32)[np.asarray(tris, np.int64)]


# --------------------------------------------------------------------------
# camera (host, float32)
# --------------------------------------------------------------------------
def look_at(eye, target, up):
    """World→camera look-at (OpenCV convention: x right, y down in the
    image, z forward): (R (3, 3), eye (3,)), X_cam = R @ (X − eye)."""
    eye = np.asarray(eye, np.float32)
    fwd = np.asarray(target, np.float32) - eye
    fwd = fwd / np.maximum(np.linalg.norm(fwd), np.float32(1e-9))
    up = np.asarray(up, np.float32)
    right = np.cross(fwd, up)
    right = right / np.maximum(np.linalg.norm(right), np.float32(1e-9))
    down = np.cross(fwd, right)
    return np.stack([right, down, fwd]).astype(np.float32), eye


def intrinsics_from_fov(fov_v_deg: float, height: int, width: int):
    """Vertical-FOV pinhole K (Open3D's offscreen default is 60°)."""
    f = 0.5 * height / np.tan(np.radians(fov_v_deg) / 2.0)
    return np.array([[f, 0, width / 2.0], [0, f, height / 2.0],
                     [0, 0, 1]], np.float32)


# --------------------------------------------------------------------------
# rasterizer core (tensors on one device)
# --------------------------------------------------------------------------
def _project(pts_w, R, eye, K):
    """(…, 3) world → (uv (…, 2), z (…,))."""
    pc = (pts_w - eye) @ R.T
    z = pc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    u = K[0, 0] * pc[..., 0] / zs + K[0, 2]
    v = K[1, 1] * pc[..., 1] / zs + K[1, 2]
    return torch.stack([u, v], dim=-1), z


def _tri_chunk(depth, color, px, py, cuv, cz, ccol, cok):
    """One chunk of triangles into the (depth, color) buffers."""
    a, b, c = cuv[:, 0], cuv[:, 1], cuv[:, 2]

    def edge(p, q):
        # E(x, y) = (q − p) × (pix − p): the side of edge pq
        return ((q[:, 0] - p[:, 0])[:, None, None]
                * (py[None] - p[:, 1][:, None, None])
                - (q[:, 1] - p[:, 1])[:, None, None]
                * (px[None] - p[:, 0][:, None, None]))

    e0, e1, e2 = edge(b, c), edge(c, a), edge(a, b)     # (C, H, W)
    area = e0 + e1 + e2
    inside = (((e0 >= 0) & (e1 >= 0) & (e2 >= 0))
              | ((e0 <= 0) & (e1 <= 0) & (e2 <= 0)))
    inside &= torch.abs(area) > 1e-8
    inside &= cok[:, None, None]
    area_s = torch.where(torch.abs(area) < 1e-8, torch.full_like(area, 1e-8),
                         area)
    inv_z = (e0 / area_s * (1.0 / cz[:, 0])[:, None, None]
             + e1 / area_s * (1.0 / cz[:, 1])[:, None, None]
             + e2 / area_s * (1.0 / cz[:, 2])[:, None, None])
    zpix = 1.0 / torch.clamp(inv_z, min=1e-9)
    zpix = torch.where(inside, zpix, torch.full_like(zpix, torch.inf))
    zmin, win = torch.min(zpix, dim=0)
    closer = zmin < depth
    return (torch.where(closer, zmin, depth),
            torch.where(closer[..., None], ccol[win], color))


def _window(x0, x1, y0, y1, valid, reach: float, H: int, W: int):
    """The pixel rows and columns (two slices) whose centres may lie within
    ``reach`` of the boxes ``[x0, x1] × [y0, y1]`` of the ``valid``
    primitives, two pixels wider for rounding and clipped to the frame, or
    None when no primitive is valid. No pixel outside it is covered by a
    primitive of the pass, so the pass is exact on the window alone. One
    host read of four numbers."""
    inf = torch.full_like(x0, torch.inf)
    b = torch.stack([torch.where(valid, x0, inf).min(),
                     -torch.where(valid, x1, -inf).max(),
                     torch.where(valid, y0, inf).min(),
                     -torch.where(valid, y1, -inf).max()]).cpu().tolist()
    if not all(math.isfinite(v) for v in b):
        return None
    pad = reach + 2.0
    c0, c1 = max(0, math.floor(b[0] - pad)), min(W, math.ceil(-b[1] + pad))
    r0, r1 = max(0, math.floor(b[2] - pad)), min(H, math.ceil(-b[3] + pad))
    if c0 >= c1 or r0 >= r1:
        return None
    return slice(r0, r1), slice(c0, c1)


@torch.no_grad()
def render_frame(tri_verts, tri_colors, tri_valid, seg_verts, seg_colors,
                 seg_valid, cam_R, cam_eye, K, *, height: int, width: int,
                 chunk: int = 64, background=(1.0, 1.0, 1.0),
                 sun_dir=(0.2, -1.0, 0.2), sun_strength: float = 0.85,
                 ambient: float = 0.35, line_width: float = 3.0,
                 znear: float = 0.05, point_centers=None, point_radii=None,
                 point_colors=None, point_valid=None):
    """Rasterize triangles + thick line segments (+ optional sphere
    impostors) into an (H, W, 3) float32 image in [0, 1] and its depth.

    tri_verts (N, 3, 3) world / tri_colors (N, 3) / tri_valid (N,) bool;
    seg_verts (M, 2, 3) / seg_colors (M, 3) / seg_valid (M,) bool;
    point_centers (P, 3) / point_radii (P,) / point_colors (P, 3) /
    point_valid (P,): spheres drawn as screen circles of radius ``r·f/z``
    with a spherical depth bulge. Every tensor on one device."""
    dev = tri_verts.device
    H, W = height, width
    ys, xs = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    px = xs.to(torch.float32) + 0.5
    py = ys.to(torch.float32) + 0.5

    # flat shading: per-face Lambert on world-space normals, double-sided
    n = torch.linalg.cross(tri_verts[:, 1] - tri_verts[:, 0],
                           tri_verts[:, 2] - tri_verts[:, 0])
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True),
                        min=1e-9)
    sun = torch.tensor(sun_dir, dtype=torch.float32, device=dev)
    sun = sun / torch.linalg.vector_norm(sun)
    shade = torch.clamp(ambient + sun_strength * torch.abs(n @ (-sun)),
                        0.0, 1.0)
    lit_colors = tri_colors * shade[:, None]

    uv, z = _project(tri_verts, cam_R, cam_eye, K)     # (N, 3, 2), (N, 3)
    ok = tri_valid & torch.all(z > znear, dim=-1)

    depth = torch.full((H, W), torch.inf, device=dev)
    color = torch.tensor(background, dtype=torch.float32,
                         device=dev).expand(H, W, 3).clone()
    for s in range(0, uv.shape[0], chunk):
        depth, color = _tri_chunk(depth, color, px, py, uv[s:s + chunk],
                                  z[s:s + chunk], lit_colors[s:s + chunk],
                                  ok[s:s + chunk])

    # thick line pass: screen-space distance to segment, z-tested
    if seg_verts.shape[0]:
        suv, sz = _project(seg_verts, cam_R, cam_eye, K)  # (M,2,2), (M,2)
        sok = seg_valid & torch.all(sz > znear, dim=-1)
        win = _window(suv[..., 0].amin(1), suv[..., 0].amax(1),
                      suv[..., 1].amin(1), suv[..., 1].amax(1), sok,
                      line_width / 2.0, H, W)
        if win is not None:
            ys_, xs_ = win
            cpx, cpy = px[ys_, xs_], py[ys_, xs_]
            p0, p1 = suv[:, 0], suv[:, 1]
            d = p1 - p0
            len2 = torch.clamp(torch.sum(d * d, dim=-1), min=1e-8)
            relx = cpx[None] - p0[:, 0][:, None, None]
            rely = cpy[None] - p0[:, 1][:, None, None]
            t = ((relx * d[:, 0][:, None, None]
                  + rely * d[:, 1][:, None, None]) / len2[:, None, None])
            t = torch.clamp(t, 0.0, 1.0)
            dx = relx - t * d[:, 0][:, None, None]
            dy = rely - t * d[:, 1][:, None, None]
            on = ((dx * dx + dy * dy <= (line_width / 2.0) ** 2)
                  & sok[:, None, None])
            inv_z = ((1.0 - t) * (1.0 / sz[:, 0])[:, None, None]
                     + t * (1.0 / sz[:, 1])[:, None, None])
            zl = 1.0 / torch.clamp(inv_z, min=1e-9)
            # a small bias: coplanar lines win against their own surface
            zl = torch.where(on, zl * (1.0 - 1e-3),
                             torch.full_like(zl, torch.inf))
            zlmin, lwin = torch.min(zl, dim=0)
            closer = zlmin < depth[ys_, xs_]
            depth[ys_, xs_] = torch.where(closer, zlmin, depth[ys_, xs_])
            color[ys_, xs_] = torch.where(closer[..., None], seg_colors[lwin],
                                          color[ys_, xs_])

    # analytic sphere impostor pass
    if point_centers is not None and point_centers.shape[0]:
        pc = (point_centers - cam_eye) @ cam_R.T          # (P, 3) camera
        zc = pc[:, 2]
        pok = point_valid & (zc > znear)
        zs = torch.where(torch.abs(zc) < 1e-6, torch.full_like(zc, 1e-6), zc)
        cu = K[0, 0] * pc[:, 0] / zs + K[0, 2]
        cv = K[1, 1] * pc[:, 1] / zs + K[1, 2]
        rpx = point_radii * K[1, 1] / zs                  # screen radius
        win = _window(cu - rpx, cu + rpx, cv - rpx, cv + rpx, pok, 0.0, H, W)
        if win is not None:
            ys_, xs_ = win
            dx = px[ys_, xs_][None] - cu[:, None, None]
            dy = py[ys_, xs_][None] - cv[:, None, None]
            d2 = dx * dx + dy * dy                        # (P, h, w)
            r2 = (rpx ** 2)[:, None, None]
            on = (d2 <= r2) & pok[:, None, None]
            falloff = 1.0 - d2 / torch.clamp(r2, min=1e-9)
            # front surface of the ball
            bulge = torch.sqrt(torch.clamp(
                (point_radii ** 2)[:, None, None] * falloff, min=0.0))
            zp = torch.where(on, zc[:, None, None] - bulge,
                             torch.full_like(bulge, torch.inf))
            # lit like a sun-facing surface scaled by the spherical falloff
            shade_p = torch.clamp(ambient + sun_strength * torch.sqrt(
                torch.clamp(falloff, min=0.0)), 0.0, 1.0)
            zpmin, pwin = torch.min(zp, dim=0)
            pcol = (point_colors[pwin]
                    * torch.gather(shade_p, 0, pwin[None])[0][..., None])
            closer = zpmin < depth[ys_, xs_]
            depth[ys_, xs_] = torch.where(closer, zpmin, depth[ys_, xs_])
            color[ys_, xs_] = torch.where(closer[..., None], pcol,
                                          color[ys_, xs_])
    return color, depth


# --------------------------------------------------------------------------
# public renderer (the reference's Open3DBevVideoRenderer API)
# --------------------------------------------------------------------------
class BevView:
    """The BEV look: ``lookat``, ``up`` and the eye's height above it."""

    def __init__(self, lookat=(0.0, 0.0, 10.0), up=(0.0, 0.0, -1.0),
                 eye_height: float = 25.0):
        self.lookat = tuple(float(v) for v in lookat)
        self.up = tuple(float(v) for v in up)
        self.eye_height = float(eye_height)


class BevVideoRenderer:
    """Headless BEV skeleton video renderer on :func:`render_frame`.

    ``render((J, 3) world keypoints) → BGR uint8 frame`` (also written to
    the mp4 when ``out_path`` is given), ``render_many``, ``close``, a
    context manager. Non-finite keypoints are dropped from the spheres and
    from every edge touching them. The scene is rasterized on ``device``
    (default ``cuda``); each frame comes back to the host once."""

    def __init__(self, out_path, width: int = 1280, height: int = 720,
                 fps: int = 30, edges: Sequence[Tuple[int, int]] = COCO_EDGES,
                 meters_grid: Tuple[float, float] = (20.0, 30.0),
                 grid_origin: Tuple[float, float, float] = (-10.0, -0.01, 0.0),
                 view: Optional[BevView] = None,
                 draw_keypoints: bool = True, kp_radius: float = 0.08,
                 kp_mode: str = "impostor", line_width: float = 3.0,
                 fov_v_deg: float = 60.0, sphere_subdiv: int = 1,
                 mp4_fourcc: str = "mp4v", chunk: int = 64, device=None):
        from skix_torch.utils.device import resolve_device

        self.device = resolve_device(device)
        self.width, self.height, self.fps = int(width), int(height), int(fps)
        self.edges = np.asarray(list(edges), np.int32)
        self.view = view or BevView()
        self.draw_keypoints = bool(draw_keypoints)
        self.line_width = float(line_width)
        self.chunk = int(chunk)

        # static scene: a lit ground slab
        gx, gz = meters_grid
        gv, gt = make_box((gx, 0.01, gz), grid_origin)
        self._ground_tris = flatten_mesh(gv, gt)                 # (12,3,3)
        self._ground_cols = np.full((gt.shape[0], 3), 0.92, np.float32)
        if kp_mode not in ("impostor", "mesh"):
            raise ValueError(f"kp_mode must be impostor|mesh, got {kp_mode}")
        self.kp_mode = kp_mode
        self.kp_radius = float(kp_radius)
        self._sphere_tris = None
        if self.draw_keypoints and kp_mode == "mesh":
            sv, st = make_icosphere(kp_radius, sphere_subdiv)
            self._sphere_tris = flatten_mesh(sv, st)             # (S,3,3)

        K = intrinsics_from_fov(fov_v_deg, self.height, self.width)
        lookat = np.asarray(self.view.lookat, np.float32)
        eye = lookat + np.array([0.0, self.view.eye_height, 0.0], np.float32)
        R, eye = look_at(eye, lookat, self.view.up)
        self._cam = tuple(torch.as_tensor(c, device=self.device)
                          for c in (R, eye, K))

        self.out_path = Path(out_path) if out_path is not None else None
        self._video = None
        if self.out_path is not None:
            import cv2

            self.out_path.parent.mkdir(parents=True, exist_ok=True)
            self._video = cv2.VideoWriter(
                str(self.out_path), cv2.VideoWriter_fourcc(*mp4_fourcc),
                self.fps, (self.width, self.height))

    def _assemble(self, kpts_world: np.ndarray):
        kpts = np.asarray(kpts_world, np.float32)
        if kpts.ndim != 2 or kpts.shape[1] != 3:
            raise ValueError(f"kpts_world must be (J,3), got {kpts.shape}")
        finite = np.isfinite(kpts).all(axis=1)
        kpts = np.where(finite[:, None], kpts, 0.0).astype(np.float32)

        tris: List[np.ndarray] = [self._ground_tris]
        cols: List[np.ndarray] = [self._ground_cols]
        valid: List[np.ndarray] = [np.ones(len(self._ground_tris), bool)]
        points = None
        if self._sphere_tris is not None:
            S = len(self._sphere_tris)
            inst = self._sphere_tris[None] + kpts[:, None, None, :]
            tris.append(inst.reshape(-1, 3, 3))
            cols.append(np.tile(np.array([[1.0, 0, 0]], np.float32),
                                (len(kpts) * S, 1)))
            valid.append(np.repeat(finite, S))
        elif self.draw_keypoints:
            points = (kpts,
                      np.full((len(kpts),), self.kp_radius, np.float32),
                      np.tile(np.array([[1.0, 0, 0]], np.float32),
                              (len(kpts), 1)),
                      finite)
        segs = kpts[self.edges]                               # (M, 2, 3)
        seg_ok = finite[self.edges].all(axis=1)
        seg_cols = np.tile(np.array([[0.0, 1.0, 0.0]], np.float32),
                           (len(self.edges), 1))
        return (np.concatenate(tris), np.concatenate(cols),
                np.concatenate(valid), segs, seg_cols, seg_ok, points)

    def render(self, kpts_world: np.ndarray) -> np.ndarray:
        dev = self.device
        *scene, pts = self._assemble(kpts_world)
        pkw = {}
        if pts is not None:
            pkw = {k: torch.as_tensor(a, device=dev) for k, a in zip(
                ("point_centers", "point_radii", "point_colors",
                 "point_valid"), pts)}
        color, _ = render_frame(
            *(torch.as_tensor(a, device=dev) for a in scene), *self._cam, height=self.height, width=self.width,
            chunk=self.chunk, line_width=self.line_width, **pkw)
        rgb = (torch.clamp(color, 0, 1) * 255.0).to(torch.uint8).cpu().numpy()
        bgr = rgb[..., ::-1]
        if self._video is not None:
            self._video.write(np.ascontiguousarray(bgr))
        return bgr

    def render_many(self, kpts_seq: Iterable[np.ndarray]) -> None:
        for kpts in kpts_seq:
            self.render(kpts)

    def close(self) -> None:
        if self._video is not None:
            self._video.release()
        self._video = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()


# the reference's public name
Open3DBevVideoRenderer = BevVideoRenderer
