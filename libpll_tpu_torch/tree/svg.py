"""SVG visualization of unrooted trees.

Capability parity with `pll_utree_export_svg` / `pll_svg_attrib_create`
(libpll `src/utree_svg.c:404-462, 380-401`, attribute struct
`src/pll.h:435-450`): the unrooted tree is treated as rooted-binary with a
ternary root; x positions come from branch lengths scaled so the longest
root-to-tip path plus its label fits the canvas, y positions from in-order
tip stacking, with an optional scale-bar legend.  Pure host-side string
generation — no device work.

Counterpart: ``libpll_tpu/tree/svg.py``, copied.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from .utree import UNode, UTree


@dataclass
class SvgAttrib:
    """Defaults mirror `pll_svg_attrib_create` (utree_svg.c:416-436)."""

    width: int = 1920
    font_size: int = 12
    tip_spacing: int = 20
    stroke_width: int = 3
    legend_show: bool = True
    legend_spacing: int = 10
    legend_ratio: float = 0.1
    margin_left: int = 20
    margin_right: int = 20
    margin_bottom: int = 20
    margin_top: int = 20
    node_radius: float = 0.0
    precision: int = 7


@dataclass
class _Data:
    height: int = 0
    x: float = 0.0
    y: float = 0.0


def export_svg(tree: UTree, root: Optional[UNode] = None,
               attr: Optional[SvgAttrib] = None) -> str:
    """Render the tree as an SVG string (write it to a file for parity with
    the reference's file API)."""
    attr = attr or SvgAttrib()
    root = root or tree.root
    if root.is_tip:
        raise ValueError("root must be an inner node")

    # keyed by clv_index: shared across an inner node's ring, like the
    # reference's node->data = node->next->data = ... (utree_svg.c:76)
    data: Dict[int, _Data] = {}

    def node_data(n: UNode) -> _Data:
        return data[n.clv_index]

    def set_height(n: UNode) -> int:
        if n.is_tip:
            data[n.clv_index] = _Data()
            return 0
        ring = list(n.ring())
        h = 1 + max(set_height(ring[1].back), set_height(ring[2].back))
        data[n.clv_index] = _Data(height=h)
        return h

    set_height(root.back)
    set_height(root)
    d = node_data(root)
    if node_data(root.back).height >= d.height:
        d.height = node_data(root.back).height + 1

    canvas_width = attr.width - attr.margin_left - attr.margin_right

    # pixel scaler: for each tip, (canvas - label_len)/path_len; take min
    # (utree_scaler_init, utree_svg.c:239-289)
    scaler = None
    max_tree_len = 0.0
    max_font_len = 0.0
    for tip in (n for n in tree.nodes if n.is_tip):
        length = tip.length
        node = tip.back
        while True:
            nd = node_data(node)
            ring = list(node.ring())
            nb, nnb = ring[1].back, ring[2].back
            if node_data(nb).height > nd.height:
                node = nb
            elif node_data(nnb).height > nd.height:
                node = nnb
            else:
                break
            length += node.length
        max_tree_len = max(max_tree_len, length)
        label_len = (attr.font_size / 1.5) * len(tip.label or "")
        cand = (canvas_width - label_len) / length if length else canvas_width
        if scaler is None or cand < scaler:
            scaler = cand
            max_font_len = label_len
    scaler = scaler or 1.0

    # x offsets, pre-order (utree_set_offset, utree_svg.c:117-149)
    def set_offset(n: UNode) -> None:
        d = node_data(n)
        d.x = n.length * scaler
        pd = node_data(n.back)
        parent = n.back if pd.height > d.height else None
        if parent is not None:
            d.x += pd.x
        else:
            d.x = attr.margin_left
        if n.is_tip:
            return
        ring = list(n.ring())
        set_offset(ring[1].back)
        set_offset(ring[2].back)
        if parent is None:
            set_offset(n.back)

    out: List[str] = []

    def line(x1, y1, x2, y2, sw):
        out.append(f'<line x1="{x1:f}" y1="{y1:f}" x2="{x2:f}" y2="{y2:f}" '
                   f'stroke="#31a354" stroke-width="{sw:f}" />')

    def circle(cx, cy, r):
        out.append(f'<circle cx="{cx:f}" cy="{cy:f}" r="{r:f}" '
                   f'fill="#31a354" stroke="#31a354" />')

    svg_height = (attr.margin_top + attr.legend_spacing + attr.margin_bottom
                  + attr.tip_spacing * tree.tip_count)
    out.append(f'<svg xmlns="http://www.w3.org/2000/svg" '
               f'width="{attr.width}" height="{svg_height}" '
               f'style="border: 1px solid #cccccc;">')
    if attr.legend_show:
        lx = (canvas_width - max_font_len) * attr.legend_ratio
        line(attr.margin_left, 10, lx + attr.margin_left, 10, 3)
        out.append(f'<text x="{lx + attr.margin_left + 5:f}" '
                   f'y="{20 - attr.font_size / 3.0:f}" '
                   f'font-size="{attr.font_size}" font-family="Arial;">'
                   f'{max_tree_len * attr.legend_ratio:.{attr.precision}f}'
                   f'</text>')

    set_offset(root)

    tip_occ = [0]

    # plot, post-order (utree_plot, utree_svg.c:151-236)
    def plot(n: UNode) -> None:
        d = node_data(n)
        pd = node_data(n.back)
        parent = n.back if pd.height > d.height else None
        if not n.is_tip:
            ring = list(n.ring())
            plot(ring[1].back)
            plot(ring[2].back)
            if parent is None:
                plot(n.back)
        if parent is not None:
            x, px = d.x, pd.x
            if n.is_tip:
                y = (tip_occ[0] * attr.tip_spacing + attr.margin_top
                     + attr.legend_spacing)
                tip_occ[0] += 1
            else:
                ring = list(n.ring())
                ly = node_data(ring[1].back).y
                ry = node_data(ring[2].back).y
                y = (ly + ry) / 2.0
                line(x, ly, x, ry, attr.stroke_width)
                circle(x, y, attr.node_radius)
            line(px, y, x, y, attr.stroke_width)
            d.y = y
            if n.is_tip:
                out.append(f'<text x="{x + 5:f}" '
                           f'y="{y + attr.font_size / 3.0:f}" '
                           f'font-size="{attr.font_size}" '
                           f'font-family="Arial;">{n.label or ""}</text>')
        else:
            ring = list(n.ring())
            ly = node_data(ring[1].back).y
            ry = pd.y
            y = (ly + ry) / 2.0
            line(attr.margin_left, ly, attr.margin_left, ry,
                 attr.stroke_width)
            circle(attr.margin_left, y, attr.node_radius)

    plot(root)
    out.append("</svg>")
    return "\n".join(out) + "\n"


def export_svg_file(tree: UTree, path: str,
                    root: Optional[UNode] = None,
                    attr: Optional[SvgAttrib] = None) -> None:
    with open(path, "w") as fh:
        fh.write(export_svg(tree, root, attr))
