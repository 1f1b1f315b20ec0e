"""Minimal SVG rasterizer — the nanosvg analogue.

Reference: Loader/TextureLoader.cpp:10-12 rasterizes .svg textures through
nanosvg/nanosvgrast. This is a from-scratch subset renderer: shapes (rect,
circle, ellipse, line, polyline, polygon, path with the full command set
incl. arcs), nested <g> transforms (matrix/translate/scale/rotate), solid
fills with nonzero/evenodd rules, solid strokes (segment quads + joint
octagons), opacity, painter's-order alpha compositing, 2×2 supersampled
coverage. Gradients degrade to their first stop; unsupported features are
skipped, never fatal (matching nanosvg's lenient behavior).

Pure numpy — rasterization is scanline winding evaluated vectorized over
each shape's bbox.

The port's own copy of trident_tpu/io/svg.py (only this paragraph
differs).
"""

from __future__ import annotations

import math
import re
import xml.etree.ElementTree as ET
from typing import List, Optional, Tuple

import numpy as np

_NAMED = {
    "black": (0, 0, 0), "white": (255, 255, 255), "red": (255, 0, 0),
    "green": (0, 128, 0), "lime": (0, 255, 0), "blue": (0, 0, 255),
    "yellow": (255, 255, 0), "cyan": (0, 255, 255), "aqua": (0, 255, 255),
    "magenta": (255, 0, 255), "fuchsia": (255, 0, 255),
    "gray": (128, 128, 128), "grey": (128, 128, 128),
    "silver": (192, 192, 192), "orange": (255, 165, 0),
    "purple": (128, 0, 128), "brown": (165, 42, 42),
    "navy": (0, 0, 128), "teal": (0, 128, 128), "maroon": (128, 0, 0),
    "olive": (128, 128, 0), "pink": (255, 192, 203),
    "gold": (255, 215, 0), "indigo": (75, 0, 130),
    "darkgray": (169, 169, 169), "lightgray": (211, 211, 211),
}

_NUM = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?")


def _floats(s: str) -> List[float]:
    return [float(m) for m in _NUM.findall(s or "")]


def _parse_color(s: Optional[str]) -> Optional[Tuple[int, int, int]]:
    if not s:
        return None
    s = s.strip()
    if s in ("none", "transparent"):
        return None
    if s.startswith("#"):
        h = s[1:]
        if len(h) == 3:
            return tuple(int(c * 2, 16) for c in h)  # type: ignore
        if len(h) >= 6:
            return (int(h[0:2], 16), int(h[2:4], 16), int(h[4:6], 16))
        return (0, 0, 0)
    if s.startswith("rgb"):
        v = _floats(s)
        if len(v) >= 3:
            if "%" in s:
                v = [x * 2.55 for x in v[:3]]
            return tuple(int(min(max(x, 0), 255)) for x in v[:3])  # type: ignore
    if s.startswith("url("):
        return (128, 128, 128)  # gradient/pattern: flat gray fallback
    return _NAMED.get(s.lower(), (0, 0, 0))


def _parse_transform(s: Optional[str]) -> np.ndarray:
    m = np.eye(3)
    if not s:
        return m
    for name, args in re.findall(r"(\w+)\s*\(([^)]*)\)", s):
        v = _floats(args)
        t = np.eye(3)
        if name == "translate":
            t[0, 2] = v[0] if v else 0.0
            t[1, 2] = v[1] if len(v) > 1 else 0.0
        elif name == "scale":
            t[0, 0] = v[0] if v else 1.0
            t[1, 1] = v[1] if len(v) > 1 else t[0, 0]
        elif name == "rotate":
            a = math.radians(v[0]) if v else 0.0
            c, s_ = math.cos(a), math.sin(a)
            r = np.array([[c, -s_, 0], [s_, c, 0], [0, 0, 1]])
            if len(v) >= 3:
                pre = np.eye(3); pre[0, 2], pre[1, 2] = v[1], v[2]
                post = np.eye(3); post[0, 2], post[1, 2] = -v[1], -v[2]
                t = pre @ r @ post
            else:
                t = r
        elif name == "matrix" and len(v) >= 6:
            t = np.array([[v[0], v[2], v[4]], [v[1], v[3], v[5]], [0, 0, 1]])
        elif name == "skewX" and v:
            t[0, 1] = math.tan(math.radians(v[0]))
        elif name == "skewY" and v:
            t[1, 0] = math.tan(math.radians(v[0]))
        m = m @ t
    return m


def _apply(xf: np.ndarray, pts: np.ndarray) -> np.ndarray:
    if len(pts) == 0:
        return pts
    p = np.concatenate([pts, np.ones((len(pts), 1))], axis=1)
    return (p @ xf.T)[:, :2]


def _flatten_cubic(p0, p1, p2, p3, n=16):
    t = np.linspace(0.0, 1.0, n + 1)[1:, None]
    u = 1.0 - t
    return (u**3 * p0 + 3 * u**2 * t * p1 + 3 * u * t**2 * p2 + t**3 * p3)


def _flatten_quad(p0, p1, p2, n=12):
    t = np.linspace(0.0, 1.0, n + 1)[1:, None]
    u = 1.0 - t
    return u**2 * p0 + 2 * u * t * p1 + t**2 * p2


def _flatten_arc(p0, rx, ry, phi_deg, large, sweep, p1, n=24):
    """SVG endpoint arc → polyline (F.6.5 endpoint-to-center)."""
    if rx == 0 or ry == 0 or np.allclose(p0, p1):
        return p1[None]
    phi = math.radians(phi_deg)
    c, s = math.cos(phi), math.sin(phi)
    d = (p0 - p1) / 2.0
    x1p = c * d[0] + s * d[1]
    y1p = -s * d[0] + c * d[1]
    rx, ry = abs(rx), abs(ry)
    lam = x1p**2 / rx**2 + y1p**2 / ry**2
    if lam > 1:
        rx *= math.sqrt(lam); ry *= math.sqrt(lam)
    num = rx**2 * ry**2 - rx**2 * y1p**2 - ry**2 * x1p**2
    den = rx**2 * y1p**2 + ry**2 * x1p**2
    k = math.sqrt(max(num / den, 0.0)) * (1 if large != sweep else -1)
    cxp, cyp = k * rx * y1p / ry, -k * ry * x1p / rx
    cx = c * cxp - s * cyp + (p0[0] + p1[0]) / 2
    cy = s * cxp + c * cyp + (p0[1] + p1[1]) / 2

    def ang(ux, uy, vx, vy):
        d_ = math.atan2(ux * vy - uy * vx, ux * vx + uy * vy)
        return d_
    th1 = math.atan2((y1p - cyp) / ry, (x1p - cxp) / rx)
    dth = ang((x1p - cxp) / rx, (y1p - cyp) / ry,
              (-x1p - cxp) / rx, (-y1p - cyp) / ry)
    if not sweep and dth > 0:
        dth -= 2 * math.pi
    elif sweep and dth < 0:
        dth += 2 * math.pi
    t = th1 + np.linspace(0.0, 1.0, n + 1)[1:] * dth
    pts = np.stack([cx + rx * np.cos(t) * c - ry * np.sin(t) * s,
                    cy + rx * np.cos(t) * s + ry * np.sin(t) * c], axis=1)
    pts[-1] = p1
    return pts


def _parse_path(d: str) -> List[np.ndarray]:
    """Path data → list of subpath polylines (open subpaths stay open)."""
    tokens = re.findall(r"([MmLlHhVvCcSsQqTtAaZz])|(" + _NUM.pattern + ")", d)
    items: List = []
    for cmd, num in tokens:
        items.append(cmd if cmd else float(num))
    subpaths: List[np.ndarray] = []
    cur: List[np.ndarray] = []
    pos = np.zeros(2)
    start = np.zeros(2)
    last_ctrl = None
    last_cmd = ""
    i = 0

    def take(n):
        nonlocal i
        v = items[i:i + n]
        i += n
        if len(v) < n:
            # short coordinate list at end-of-data: lenient skip, not a
            # fatal unpacking error (module contract)
            raise _ShortPathData
        return [float(x) for x in v]

    cmd = ""
    try:
        while i < len(items):
            if isinstance(items[i], str):
                cmd = items[i]
                i += 1
            elif cmd in "Mm":  # implicit lineto after moveto
                cmd = "L" if cmd == "M" else "l"
            elif cmd in "Zz" or not cmd:
                # numbers after Z (or before any command) are malformed data:
                # the Z branch consumes no tokens, so re-entering it would
                # spin forever — lenient skip of the rest of the path
                break
            rel = cmd.islower()
            c = cmd.upper()
            if c == "M":
                x, y = take(2)
                pos = pos + (x, y) if rel else np.array([x, y])
                if len(cur) > 1:
                    subpaths.append(np.array(cur))
                cur = [pos.copy()]
                start = pos.copy()
                last_ctrl = None
            elif c == "L":
                x, y = take(2)
                pos = pos + (x, y) if rel else np.array([x, y])
                cur.append(pos.copy()); last_ctrl = None
            elif c == "H":
                (x,) = take(1)
                pos = np.array([pos[0] + x if rel else x, pos[1]])
                cur.append(pos.copy()); last_ctrl = None
            elif c == "V":
                (y,) = take(1)
                pos = np.array([pos[0], pos[1] + y if rel else y])
                cur.append(pos.copy()); last_ctrl = None
            elif c in "CS":
                if c == "C":
                    x1, y1, x2, y2, x, y = take(6)
                    p1 = pos + (x1, y1) if rel else np.array([x1, y1])
                else:
                    x2, y2, x, y = take(4)
                    p1 = (2 * pos - last_ctrl if last_ctrl is not None
                          and last_cmd in "CcSs" else pos.copy())
                p2 = pos + (x2, y2) if rel else np.array([x2, y2])
                p3 = pos + (x, y) if rel else np.array([x, y])
                cur.extend(_flatten_cubic(pos, p1, p2, p3))
                last_ctrl = p2; pos = p3
            elif c in "QT":
                if c == "Q":
                    x1, y1, x, y = take(4)
                    p1 = pos + (x1, y1) if rel else np.array([x1, y1])
                else:
                    x, y = take(2)
                    p1 = (2 * pos - last_ctrl if last_ctrl is not None
                          and last_cmd in "QqTt" else pos.copy())
                p2 = pos + (x, y) if rel else np.array([x, y])
                cur.extend(_flatten_quad(pos, p1, p2))
                last_ctrl = p1; pos = p2
            elif c == "A":
                rx, ry, rot, large, sweep, x, y = take(7)
                p1 = pos + (x, y) if rel else np.array([x, y])
                cur.extend(_flatten_arc(pos, rx, ry, rot, bool(large),
                                        bool(sweep), p1))
                pos = p1; last_ctrl = None
            elif c == "Z":
                cur.append(start.copy())
                if len(cur) > 1:
                    subpaths.append(np.array(cur))
                cur = [start.copy()]
                pos = start.copy()
                last_ctrl = None
            else:
                break
            last_cmd = cmd
    except _ShortPathData:
        pass
    if len(cur) > 1:
        subpaths.append(np.array(cur))
    return subpaths


class _ShortPathData(Exception):
    """Path data ended mid-command; the parsed prefix is still used."""


def _style(el, inherited):
    st = dict(inherited)
    # CSS priority: the style attribute BEATS presentation attributes
    # (Inkscape/Illustrator emit both; the declaration wins per spec)
    own = {}
    for k in ("fill", "stroke", "stroke-width", "fill-opacity",
              "stroke-opacity", "opacity", "fill-rule"):
        if el.get(k) is not None:
            own[k] = el.get(k)
    for part in el.get("style", "").split(";"):
        if ":" in part:
            k, v = part.split(":", 1)
            own[k.strip()] = v.strip()
    for k, v in own.items():
        if k == "opacity":
            # group opacity MULTIPLIES down the tree (a 0.8 child inside
            # a 0.5 group composites at 0.4), it is not inherited-then-
            # replaced like paint properties
            try:
                st[k] = str(float(inherited.get("opacity", 1.0)) * float(v))
            except ValueError:
                pass
        else:
            st[k] = v
    return st


def _winding(subpaths: List[np.ndarray], xs, ys, rule: str) -> np.ndarray:
    """Coverage mask at sample points (vectorized crossing count)."""
    inside = np.zeros((len(ys), len(xs)), np.int32)
    px = xs[None, :, None]
    py = ys[:, None, None]
    for poly in subpaths:
        if len(poly) < 3:
            continue
        a = poly[:-1]
        b = poly[1:]
        # close implicitly for fills
        if not np.allclose(poly[0], poly[-1]):
            a = np.concatenate([a, poly[-1:]])
            b = np.concatenate([b, poly[:1]])
        ax, ay = a[:, 0][None, None], a[:, 1][None, None]
        bx, by = b[:, 0][None, None], b[:, 1][None, None]
        cond = (ay <= py) != (by <= py)
        with np.errstate(divide="ignore", invalid="ignore"):
            xint = ax + (py - ay) * (bx - ax) / np.where(by == ay, 1.0,
                                                         by - ay)
        crosses = cond & (px < xint)
        if rule == "evenodd":
            inside ^= crosses.sum(axis=2).astype(np.int32) & 1
        else:
            inside += np.where(crosses, np.where(by > ay, 1, -1), 0).sum(axis=2)
    return (inside & 1).astype(bool) if rule == "evenodd" else inside != 0


def _ccw(poly: np.ndarray) -> np.ndarray:
    """Force positive shoelace orientation — stroke pieces overlap, and
    under the nonzero rule mixed orientations cancel into holes."""
    a, b = poly[:-1], poly[1:]
    area = np.sum(a[:, 0] * b[:, 1] - b[:, 0] * a[:, 1])
    return poly if area >= 0 else poly[::-1]


def _stroke_polys(subpaths: List[np.ndarray], width: float) -> List[np.ndarray]:
    """Stroke geometry: one quad per segment + octagon per vertex, all in
    one consistent winding."""
    hw = max(width, 1e-3) / 2.0
    polys = []
    oct_a = np.linspace(0, 2 * math.pi, 9)[:-1]
    octagon = np.stack([np.cos(oct_a), np.sin(oct_a)], axis=1) * hw
    octagon = np.concatenate([octagon, octagon[:1]])
    for poly in subpaths:
        for k in range(len(poly) - 1):
            p, q = poly[k], poly[k + 1]
            d = q - p
            n = np.linalg.norm(d)
            if n < 1e-9:
                continue
            t = d / n
            m = np.array([-t[1], t[0]]) * hw
            polys.append(_ccw(np.array([p + m, q + m, q - m, p - m, p + m])))
        for p in poly:
            polys.append(_ccw(octagon + p))
    return polys


def rasterize_svg(text: str, width: Optional[int] = None,
                  height: Optional[int] = None,
                  supersample: int = 2) -> np.ndarray:
    """Rasterize SVG source → (H,W,4) uint8 straight-alpha."""
    root = ET.fromstring(text)

    def tag(el):
        return el.tag.rsplit("}", 1)[-1]

    vb = _floats(root.get("viewBox", ""))
    if len(vb) == 4:
        vx, vy, vw, vh = vb
    else:
        vx = vy = 0.0
        vw = (_floats(root.get("width", ""))[:1] or [64.0])[0]
        vh = (_floats(root.get("height", ""))[:1] or [64.0])[0]
    if width is None:
        width = max(int(round((_floats(root.get("width", ""))[:1]
                               or [vw])[0])), 1)
    if height is None:
        height = max(int(round((_floats(root.get("height", ""))[:1]
                                or [vh])[0])), 1)

    ss = max(int(supersample), 1)
    # view transform: viewBox → supersampled pixel space
    view = np.diag([width * ss / vw, height * ss / vh, 1.0])
    view[0, 2] = -vx * width * ss / vw
    view[1, 2] = -vy * height * ss / vh

    canvas = np.zeros((height * ss, width * ss, 4), np.float32)

    def composite(mask, rgba):
        ys_, xs_ = np.nonzero(mask)
        if len(ys_) == 0:
            return
        a = rgba[3]
        dst = canvas[ys_, xs_]
        out_a = a + dst[:, 3] * (1 - a)
        rgb = rgba[:3] * a + dst[:, :3] * dst[:, 3:4] * (1 - a)
        canvas[ys_, xs_, :3] = rgb / np.maximum(out_a[:, None], 1e-6)
        canvas[ys_, xs_, 3] = out_a

    def shape_mask(subpaths, rule):
        all_pts = np.concatenate([p for p in subpaths if len(p)], axis=0)
        x0 = max(int(np.floor(all_pts[:, 0].min())), 0)
        x1 = min(int(np.ceil(all_pts[:, 0].max())) + 1, width * ss)
        y0 = max(int(np.floor(all_pts[:, 1].min())), 0)
        y1 = min(int(np.ceil(all_pts[:, 1].max())) + 1, height * ss)
        if x1 <= x0 or y1 <= y0:
            return None
        mask = np.zeros((height * ss, width * ss), bool)
        xs_ = np.arange(x0, x1) + 0.5
        # row-chunk to bound memory: pixels × edges
        n_edges = sum(len(p) for p in subpaths)
        rows = max(1, min(y1 - y0, int(4e6 / max(n_edges * (x1 - x0), 1)) + 1))
        for ry in range(y0, y1, rows):
            ys_ = np.arange(ry, min(ry + rows, y1)) + 0.5
            mask[ry:ry + len(ys_), x0:x1] = _winding(subpaths, xs_, ys_, rule)
        return mask

    def walk(el, xf, st):
        st = _style(el, st)
        xf = xf @ _parse_transform(el.get("transform"))
        t = tag(el)
        subpaths: List[np.ndarray] = []
        if t == "path" and el.get("d"):
            subpaths = _parse_path(el.get("d"))
        elif t == "rect":
            x, y = float(el.get("x", 0)), float(el.get("y", 0))
            w_, h_ = float(el.get("width", 0)), float(el.get("height", 0))
            subpaths = [np.array([[x, y], [x + w_, y], [x + w_, y + h_],
                                  [x, y + h_], [x, y]])]
        elif t in ("circle", "ellipse"):
            cx, cy = float(el.get("cx", 0)), float(el.get("cy", 0))
            rx = float(el.get("r", el.get("rx", 0)) or 0)
            ry = float(el.get("r", el.get("ry", 0)) or 0)
            a = np.linspace(0, 2 * math.pi, 49)
            subpaths = [np.stack([cx + rx * np.cos(a), cy + ry * np.sin(a)],
                                 axis=1)]
        elif t == "line":
            subpaths = [np.array([[float(el.get("x1", 0)), float(el.get("y1", 0))],
                                  [float(el.get("x2", 0)), float(el.get("y2", 0))]])]
        elif t in ("polygon", "polyline"):
            v = _floats(el.get("points", ""))
            pts = np.array(v, np.float64).reshape(-1, 2)
            if t == "polygon" and len(pts):
                pts = np.concatenate([pts, pts[:1]])
            subpaths = [pts] if len(pts) >= 2 else []

        if subpaths:
            world = [_apply(xf, p) for p in subpaths if len(p) >= 2]
            opacity = float(st.get("opacity", 1.0))
            fill = _parse_color(st.get("fill", "black"))
            # polyline fills as an implicitly-closed shape per the spec
            # (and nanosvg); only <line> has nothing to fill
            if fill is not None and t != "line":
                a = opacity * float(st.get("fill-opacity", 1.0))
                mask = shape_mask(world, st.get("fill-rule", "nonzero"))
                if mask is not None and a > 0:
                    composite(mask, np.array([*(c / 255.0 for c in fill), a],
                                             np.float32))
            stroke = _parse_color(st.get("stroke"))
            if stroke is not None:
                sw = float((_floats(st.get("stroke-width", "1")) or [1.0])[0])
                scale = math.sqrt(abs(np.linalg.det(xf[:2, :2]))) or 1.0
                polys = _stroke_polys(world, sw * scale)
                if polys:
                    a = opacity * float(st.get("stroke-opacity", 1.0))
                    mask = shape_mask(polys, "nonzero")
                    if mask is not None and a > 0:
                        composite(mask, np.array(
                            [*(c / 255.0 for c in stroke), a], np.float32))
        for child in el:
            if tag(child) not in ("defs", "symbol", "clipPath", "mask",
                                  "style", "metadata", "title", "desc"):
                walk(child, xf, st)

    for child in root:
        if tag(child) not in ("defs", "symbol", "clipPath", "mask", "style",
                              "metadata", "title", "desc"):
            walk(child, view, {})

    # box-filter the supersampled coverage down and convert to uint8.
    # Average PREMULTIPLIED color: uncovered subpixels are rgb=0 a=0, and
    # averaging straight alpha with them darkens every edge (a half-
    # covered red pixel must stay pure red at alpha 0.5, not 25% red)
    if ss > 1:
        grid = canvas.reshape(height, ss, width, ss, 4)
        pre = np.concatenate([grid[..., :3] * grid[..., 3:4],
                              grid[..., 3:4]], axis=-1).mean(axis=(1, 3))
        a = pre[..., 3:4]
        canvas = np.concatenate(
            [pre[..., :3] / np.where(a > 1e-6, a, 1.0), a], axis=-1)
    return np.clip(np.round(canvas * 255.0), 0, 255).astype(np.uint8)


def rasterize_svg_file(path: str, width: Optional[int] = None,
                       height: Optional[int] = None) -> np.ndarray:
    with open(path, "r", encoding="utf-8") as f:
        return rasterize_svg(f.read(), width, height)
