"""Filled shapes drawn as OpenCV draws them, without cv2.

The shapes dataset (data/shapes.py) draws with ``cv2.rectangle``,
``cv2.circle`` and ``cv2.fillPoly``, each filled, 8-connected, with no
sub-pixel shift, and viz/visualize.py outlines boxes with
``cv2.rectangle`` (thickness 1 and 2) and ``cv2.line``; where the port
runs there is no cv2. These are those calls in numpy, pixel for pixel
(OpenCV's drawing.cpp):

* ``rectangle``: filled, the inclusive box between the two corners,
  clipped; outlined, ``PolyLine`` of ``ThickLine`` edges (``line`` at
  thickness 1; at 2 ``FillConvexPoly`` quads in 16.16 fixed point with
  ``Line2`` outlines, and ``Circle`` caps);
* ``circle``: the integer midpoint circle of ``Circle`` (drawing.cpp),
  filled by horizontal spans, clipped span by span;
* ``fill_poly``: ``CollectPolyEdges`` + ``FillEdgeCollection``: the
  outline drawn by the 8-connected ``LineIterator`` (Bresenham, ends
  clipped by ``clipLine``), edges in 16.16 fixed point from the clipped
  ends, scanlines filled from the left edge rounded up to the right edge
  rounded down. An edge with an end outside the image takes the x of its
  clipped ends; where those ends share a row (the edge only touches the
  image, or lies outside it), it keeps its own rows and so runs
  vertically at the border: OpenCV 5 paints the part of a polygon beyond
  the left or right border onto the border column that way.

All three equal OpenCV 5's anywhere, clipped or not: ``fill_poly`` on
concave and self-intersecting polygons of up to 80 vertices lying partly
or mostly outside the image (tests/test_torch_shapes.py,
tests/test_torch_augment.py).

Each draws in place into a u8 [H, W] or [H, W, C] array and returns it;
``color`` is a number or a sequence of C numbers.
"""

from __future__ import annotations

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _hline(img: np.ndarray, y: int, x1: int, x2: int, color) -> None:
    """ICV_HLINE: pixels x1..x2 (inclusive) of row y."""
    img[y, x1:x2 + 1] = color


def rectangle(img: np.ndarray, pt1, pt2, color,
              thickness: int = -1) -> np.ndarray:
    """cv2.rectangle(img, pt1, pt2, color, thickness): (x, y) corners,
    both included. thickness -1 fills; 1 and 2 draw the outline as
    OpenCV's ``PolyLine`` of four ``ThickLine`` edges (LINE_8, shift 0):
    at 1 four 8-connected lines, at 2 a filled quad per edge (three
    pixels wide) and a radius-1 disc at each corner."""
    if thickness < 0:
        H, W = img.shape[:2]
        x1, x2 = sorted((int(pt1[0]), int(pt2[0])))
        y1, y2 = sorted((int(pt1[1]), int(pt2[1])))
        x1, y1 = max(x1, 0), max(y1, 0)
        x2, y2 = min(x2, W - 1), min(y2, H - 1)
        if x1 <= x2 and y1 <= y2:
            img[y1:y2 + 1, x1:x2 + 1] = color
        return img
    if thickness not in (1, 2):
        raise ValueError(f"rectangle draws thickness -1, 1 or 2, got "
                         f"{thickness}")
    (xa, ya), (xb, yb) = (int(pt1[0]), int(pt1[1])), (int(pt2[0]),
                                                        int(pt2[1]))
    v = [(xa, ya), (xb, ya), (xb, yb), (xa, yb)]
    p0 = v[3]
    for p in v:                          # closed: every edge flags = 2
        _thick_line(img, p0, p, color, thickness, 2)
        p0 = p
    return img


def line(img: np.ndarray, pt1, pt2, color, thickness: int = 1):
    """cv2.line(img, pt1, pt2, color, 1) (LINE_8): the 8-connected
    LineIterator's pixels, clipped."""
    if thickness != 1:
        raise ValueError(f"line draws thickness 1, got {thickness}")
    _thick_line(img, (int(pt1[0]), int(pt1[1])),
                (int(pt2[0]), int(pt2[1])), color, 1, 3)
    return img


def _put(img, pts, color) -> None:
    H, W = img.shape[:2]
    for x, y in pts:
        if 0 <= x < W and 0 <= y < H:
            img[y, x] = color


def _thick_line(img, p0, p1, color, thickness: int, flags: int) -> None:
    """ThickLine (drawing.cpp) for integer end points, LINE_8."""
    H, W = img.shape[:2]
    if thickness <= 1:
        _put(img, line_points(W, H, p0, p1), color)
        return
    q0 = (p0[0] << XY_SHIFT, p0[1] << XY_SHIFT)
    q1 = (p1[0] << XY_SHIFT, p1[1] << XY_SHIFT)
    dx = (q0[0] - q1[0]) / XY_ONE
    dy = (q1[1] - q0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    th = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (th + odd * XY_ONE * 0.5) / np.sqrt(r)
        dpx, dpy = _cv_round(dy * r), _cv_round(dx * r)
        quad = [(q0[0] + dpx, q0[1] + dpy), (q0[0] - dpx, q0[1] - dpy),
                (q1[0] - dpx, q1[1] - dpy), (q1[0] + dpx, q1[1] + dpy)]
        fill_convex_poly(img, quad, color)
    c = q0
    for i in range(2):
        if flags & (i + 1):
            center = ((c[0] + (XY_ONE >> 1)) >> XY_SHIFT,
                      (c[1] + (XY_ONE >> 1)) >> XY_SHIFT)
            circle(img, center, (th + (XY_ONE >> 1)) >> XY_SHIFT, color)
        c = q1


def _cv_round(v: float) -> int:
    """cvRound: to nearest, halves to even (lrint)."""
    return int(np.rint(v))


def _line2(img, p1, p2, color) -> None:
    """Line2 (drawing.cpp): an 8-connected line between 16.16 fixed-point
    end points, clipped on the scaled image."""
    H, W = img.shape[:2]
    ok, p1, p2 = clip_line(W << XY_SHIFT, H << XY_SHIFT, p1, p2)
    if not ok:
        return
    (x1, y1), (x2, y2) = p1, p2
    dx, dy = x2 - x1, y2 - y1
    j = -1 if dx < 0 else 0
    ax = (dx ^ j) - j
    i = -1 if dy < 0 else 0
    ay = (dy ^ i) - i
    pts = []
    if ax > ay:
        dy = (dy ^ j) - j
        if j:
            x1, x2, y1, y2 = x2, x1, y2, y1
        y_step = _c_div(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        dx = (dx ^ i) - i
        if i:
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step = _c_div(dx << XY_SHIFT, ay | 1)
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1
    pts.append(((x2 + (XY_ONE >> 1)) >> XY_SHIFT,
                (y2 + (XY_ONE >> 1)) >> XY_SHIFT))
    if ax > ay:
        x1 >>= XY_SHIFT
        while ecount >= 0:
            pts.append((x1, y1 >> XY_SHIFT))
            x1 += 1
            y1 += y_step
            ecount -= 1
    else:
        y1 >>= XY_SHIFT
        while ecount >= 0:
            pts.append((x1 >> XY_SHIFT, y1))
            x1 += x_step
            y1 += 1
            ecount -= 1
    _put(img, pts, color)


def fill_convex_poly(img: np.ndarray, v, color) -> None:
    """FillConvexPoly (drawing.cpp), LINE_8, on 16.16 fixed-point vertices
    (shift XY_SHIFT, as ThickLine calls it): the outline by ``Line2``,
    then scanlines between the two edge chains walked from the top
    vertex."""
    H, W = img.shape[:2]
    npts = len(v)
    delta = XY_ONE >> 1
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    p0 = v[-1]
    for k, p in enumerate(v):
        if p[1] < ymin:
            ymin, imin = p[1], k
        ymax, xmax, xmin = max(ymax, p[1]), max(xmax, p[0]), min(xmin, p[0])
        _line2(img, p0, p, color)
        p0 = p
    xmin, xmax = (xmin + delta) >> XY_SHIFT, (xmax + delta) >> XY_SHIFT
    ymin, ymax = (ymin + delta) >> XY_SHIFT, (ymax + delta) >> XY_SHIFT
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= W or ymin >= H:
        return
    ymax = min(ymax, H - 1)
    edges = npts
    e_idx, e_di = [imin, imin], [1, npts - 1]
    e_x, e_dx, e_ye = [-XY_ONE, -XY_ONE], [0, 0], [ymin, ymin]
    y = ymin
    while True:
        for i in range(2):
            if y >= e_ye[i]:
                idx0, di = e_idx[i], e_di[i]
                idx = idx0 + di
                if idx >= npts:
                    idx -= npts
                while True:
                    edges -= 1
                    if edges < 0:
                        break
                    ty = (v[idx][1] + delta) >> XY_SHIFT
                    if ty > y:
                        xs, xe = v[idx0][0], v[idx][0]
                        e_ye[i] = ty
                        e_dx[i] = _c_div((xe - xs) * 2 + (ty - y),
                                         2 * (ty - y))
                        e_x[i] = xs
                        e_idx[i] = idx
                        break
                    idx0 = idx
                    idx += di
                    if idx >= npts:
                        idx -= npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if e_x[0] > e_x[1] else (0, 1)
            xx1 = (e_x[left] + delta) >> XY_SHIFT
            xx2 = (e_x[right] + delta) >> XY_SHIFT
            if xx2 >= 0 and xx1 < W:
                _hline(img, y, max(xx1, 0), min(xx2, W - 1), color)
        e_x[0] += e_dx[0]
        e_x[1] += e_dx[1]
        y += 1
        if y > ymax:
            break


def circle(img: np.ndarray, center, radius: int, color) -> np.ndarray:
    """cv2.circle(img, center, radius, color, -1) (``Circle``, fill=1)."""
    H, W = img.shape[:2]
    cx, cy = int(center[0]), int(center[1])
    radius = int(radius)
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    inside = (cx >= radius and cx < W - radius and cy >= radius
              and cy < H - radius)
    while dx >= dy:
        y11, y12, y21, y22 = cy - dy, cy + dy, cy - dx, cy + dx
        x11, x12, x21, x22 = cx - dx, cx + dx, cx - dy, cx + dy
        if inside:
            for y in (y11, y12):
                _hline(img, y, x11, x12, color)
            for y in (y21, y22):
                _hline(img, y, x21, x22, color)
        elif x11 < W and x12 >= 0 and y21 < H and y22 >= 0:
            x11, x12 = max(x11, 0), min(x12, W - 1)
            for y in (y11, y12):
                if 0 <= y < H:
                    _hline(img, y, x11, x12, color)
            if x21 < W and x22 >= 0:
                x21, x22 = max(x21, 0), min(x22, W - 1)
                for y in (y21, y22):
                    if 0 <= y < H:
                        _hline(img, y, x21, x22, color)
        dy += 1
        err += plus
        plus += 2
        mask = 0 if err <= 0 else -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return img


def clip_line(W: int, H: int, p1, p2):
    """cv::clipLine on an image of W x H. Returns (inside, p1, p2) with
    the points as OpenCV leaves them. ``int()`` of a float truncates
    toward zero, as C's (int64) cast of a double."""
    x1, y1 = p1
    x2, y2 = p2
    right, bottom = W - 1, H - 1
    code = lambda x, y: ((x < 0) + (x > right) * 2 + (y < 0) * 4
                         + (y > bottom) * 8)
    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def line_points(W: int, H: int, p1, p2):
    """The pixels of cv::LineIterator(img, p1, p2, 8, leftToRight=true),
    in order."""
    if not (0 <= p1[0] < W and 0 <= p2[0] < W and 0 <= p1[1] < H
            and 0 <= p2[1] < H):
        ok, p1, p2 = clip_line(W, H, p1, p2)
        if not ok:
            return []
    (x1, y1), (x2, y2) = p1, p2
    sx = sy = 1
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:                                  # left to right
        dx, dy = -dx, -dy
        x1, y1, x2, y2 = x2, y2, x1, y1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - (dy + dy)
    plus_delta, minus_delta = dx + dx, -(dy + dy)
    x, y = x1, y1
    out = []
    for _ in range(dx + 1):
        out.append((x, y))
        minor = err < 0
        err += minus_delta + (plus_delta if minor else 0)
        if vert:                    # y is the major axis
            y += sy
            x += sx if minor else 0
        else:
            x += sx
            y += sy if minor else 0
    return out


class _Edge:
    __slots__ = ("y0", "y1", "x", "dx", "next")

    def __init__(self, y0=0, y1=0, x=0, dx=0):
        self.y0, self.y1, self.x, self.dx, self.next = y0, y1, x, dx, None


def _c_div(a: int, b: int) -> int:
    """C's integer division: toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def fill_poly(img: np.ndarray, pts, color) -> np.ndarray:
    """cv2.fillPoly(img, pts, color) with one contour or several: pts
    [N, 2] or [C, N, 2] integer (x, y) vertices (LINE_8, shift 0)."""
    H, W = img.shape[:2]
    pts = np.asarray(pts, np.int64)
    contours = pts if pts.ndim == 3 else pts[None]
    edges = []
    for contour in contours:
        v = [(int(x), int(y)) for x, y in contour]
        x0, y0 = v[-1]
        pt0 = (x0 << XY_SHIFT, y0)
        for x1, y1 in v:
            pt1 = (x1 << XY_SHIFT, y1)
            t0 = ((pt0[0] + (XY_ONE >> 1)) >> XY_SHIFT, pt0[1])
            t1 = ((pt1[0] + (XY_ONE >> 1)) >> XY_SHIFT, pt1[1])
            for x, y in line_points(W, H, t0, t1):
                img[y, x] = color
            pt0c, pt1c = list(pt0), list(pt1)
            if not (0 <= t0[0] < W and 0 <= t1[0] < W and 0 <= t0[1] < H
                    and 0 <= t1[1] < H):
                # the edge's x from the clipped ends, its rows from them
                # where they still span rows (else it runs vertically at
                # the border)
                _, c0, c1 = clip_line(W, H, t0, t1)
                pt0c[0], pt1c[0] = c0[0] << XY_SHIFT, c1[0] << XY_SHIFT
                if c0[1] != c1[1]:
                    pt0c[1], pt1c[1] = c0[1], c1[1]
            if pt0[1] != pt1[1]:
                dx = _c_div(pt1c[0] - pt0c[0], pt1c[1] - pt0c[1])
                if pt0[1] < pt1[1]:
                    edges.append(_Edge(pt0[1], pt1[1],
                                       pt0c[0] + (pt0[1] - pt0c[1]) * dx, dx))
                else:
                    edges.append(_Edge(pt1[1], pt0[1],
                                       pt1c[0] + (pt1[1] - pt1c[1]) * dx, dx))
            pt0 = pt1
    _fill_edges(img, edges, color)
    return img


def _fill_edges(img: np.ndarray, edges: list, color) -> None:
    """FillEdgeCollection: scanlines between active edge pairs."""
    H, W = img.shape[:2]
    total = len(edges)
    if total < 2:
        return
    y_min = min(e.y0 for e in edges)
    y_max = max(e.y1 for e in edges)
    ends = [e.x + (e.y1 - e.y0) * e.dx for e in edges]
    x_min = min(min(e.x for e in edges), min(ends))
    x_max = max(max(e.x for e in edges), max(ends))
    if y_max < 0 or y_min >= H or x_max < 0 or x_min >= (W << XY_SHIFT):
        return
    edges.sort(key=lambda e: (e.y0, e.x, e.dx))
    edges.append(_Edge(y0=2 ** 31 - 1))
    tmp = _Edge()
    i = 0
    e = edges[0]
    y_max = min(y_max, H)
    for y in range(e.y0, y_max):
        draw = False
        clip = y < 0
        prelast, last = tmp, tmp.next
        while last is not None or e.y0 == y:
            if last is not None and last.y1 == y:
                prelast.next = last.next    # the edge ends here
                last = last.next
                continue
            keep_prelast = prelast
            if last is not None and (e.y0 > y or last.x < e.x):
                prelast, last = last, last.next
            elif i < total:                 # an edge starts here
                prelast.next = e
                e.next = last
                prelast = e
                i += 1
                e = edges[i]
            else:
                break
            if draw:
                if not clip:
                    # span from the left edge rounded up to the right
                    # edge rounded down
                    if keep_prelast.x > prelast.x:
                        x1 = (prelast.x + XY_ONE - 1) >> XY_SHIFT
                        x2 = keep_prelast.x >> XY_SHIFT
                    else:
                        x1 = (keep_prelast.x + XY_ONE - 1) >> XY_SHIFT
                        x2 = prelast.x >> XY_SHIFT
                    if x1 < W and x2 >= 0:
                        _hline(img, y, max(x1, 0), min(x2, W - 1), color)
                keep_prelast.x += keep_prelast.dx
                prelast.x += prelast.dx
            draw = not draw
        # bubble sort of the active list by x
        keep_prelast = None
        while True:
            prelast, last = tmp, tmp.next
            last_exchange = None
            while last is not keep_prelast and last.next is not None:
                te = last.next
                if last.x > te.x:
                    prelast.next = te
                    last.next = te.next
                    te.next = last
                    prelast = te
                    last_exchange = prelast
                else:
                    prelast, last = last, te
            if last_exchange is None:
                break
            keep_prelast = last_exchange
            if keep_prelast is tmp.next or keep_prelast is tmp:
                break
