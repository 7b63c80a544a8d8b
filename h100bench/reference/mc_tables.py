"""The marching-cubes tables of the plain reference, worked out from first
principles at import: for each of the 256 corner-sign cases, crossing
points on the cube's edges are joined by segments on its faces that
separate inside corners (value < level) from outside ones, with the
ambiguity rule "segments hug inside corners"; the loops are
fan-triangulated and oriented from inside to outside.

Conventions: corner b has offset (b&1, b>>1&1, b>>2&1); case bit b is set
when corner b is inside; local edge id = axis*4 + rank, the rank indexing
the four parallel edges in increasing base-corner order. A frozen copy of
the construction in the port's ``tools/gen_mc_tables.py``, kept here so
that the benchmark's yardstick cannot move with the program."""

from __future__ import annotations

import numpy as np

CORNER_OFFSETS = np.array(
    [[(b >> a) & 1 for a in range(3)] for b in range(8)], dtype=np.int32
)

# local edges: (base corner, axis), id = axis*4 + rank
EDGES = []
for axis in range(3):
    bit = 1 << axis
    bases = [b for b in range(8) if not (b & bit)]
    for b in bases:
        EDGES.append((b, axis))
EDGE_OF = {(b, a): i for i, (b, a) in enumerate(EDGES)}

# 6 faces: (fixed axis, fixed value) with their 4 corners in cyclic order
FACES = []
for axis in range(3):
    for val in (0, 1):
        corners = [b for b in range(8) if ((b >> axis) & 1) == val]
        # order cyclically around the face using the two free axes
        a1, a2 = [a for a in range(3) if a != axis]
        def key(b):
            return (((b >> a1) & 1), ((b >> a2) & 1))
        ordered = sorted(corners, key=key)
        # sorted gives (0,0),(0,1),(1,0),(1,1) → reorder to cycle
        cyc = [ordered[0], ordered[1], ordered[3], ordered[2]]
        FACES.append(cyc)


def face_edges(cyc):
    """The 4 edges of a face as (corner_a, corner_b) canonical pairs, in
    cyclic order."""
    out = []
    for i in range(4):
        a, b = cyc[i], cyc[(i + 1) % 4]
        axis = (a ^ b).bit_length() - 1
        base = min(a, b)
        out.append(EDGE_OF[(base, axis)])
    return out


def build_case(case):
    inside = [(case >> b) & 1 == 1 for b in range(8)]
    crossing = set()
    for eid, (b, axis) in enumerate(EDGES):
        b2 = b | (1 << axis)
        if inside[b] != inside[b2]:
            crossing.add(eid)
    if not crossing:
        return []

    # segments on faces
    segs = []
    for cyc in FACES:
        eids = face_edges(cyc)
        cross = [e for e in eids if e in crossing]
        if len(cross) == 0:
            continue
        if len(cross) == 2:
            segs.append(tuple(cross))
        elif len(cross) == 4:
            # ambiguous face: hug the inside corners. For each inside corner
            # on this face, connect the two crossing edges incident to it.
            for i, c in enumerate(cyc):
                if inside[c]:
                    e_prev = eids[(i - 1) % 4]
                    e_next = eids[i]
                    # both must be crossing (corner inside, neighbors outside
                    # in the ambiguous config)
                    if e_prev in crossing and e_next in crossing:
                        segs.append((e_prev, e_next))
        else:
            raise AssertionError("odd crossing count on a face")

    # build loops: each crossing edge appears in exactly 2 segments
    adj = {}
    for a, b in segs:
        adj.setdefault(a, []).append(b)
        adj.setdefault(b, []).append(a)
    for e, ns in adj.items():
        assert len(ns) == 2, (case, e, ns)

    loops = []
    unused = set(crossing)
    while unused:
        start = min(unused)
        loop = [start]
        unused.discard(start)
        prev, cur = None, start
        while True:
            nxt = [n for n in adj[cur] if n != prev]
            # when both neighbors equal prev (2-loop) pick the other entry
            if not nxt:
                nxt = [n for n in adj[cur]]
            n = nxt[0]
            if n == start:
                break
            loop.append(n)
            unused.discard(n)
            prev, cur = cur, n
        assert len(loop) >= 3, (case, loop)
        loops.append(loop)

    # crossing point position per edge (midpoint — only orientation matters)
    def epos(eid):
        b, axis = EDGES[eid]
        p = CORNER_OFFSETS[b].astype(float).copy()
        p[axis] += 0.5
        return p

    ins_pts = CORNER_OFFSETS[[b for b in range(8) if inside[b]]].astype(float)
    out_pts = CORNER_OFFSETS[[b for b in range(8) if not inside[b]]].astype(float)

    tris = []
    for loop in loops:
        pts = [epos(e) for e in loop]
        centroid = np.mean(pts, axis=0)
        # Newell normal of the polygon
        nrm = np.zeros(3)
        for i in range(len(pts)):
            p, q = pts[i], pts[(i + 1) % len(pts)]
            nrm += np.cross(p - centroid, q - centroid)
        # orient to agree with the 'descent' vertex-normal convention
        # (normals = -gradient, pointing toward the inside/negative side):
        # triangle normal points from outside toward inside.
        ref = np.mean(out_pts, axis=0) - np.mean(ins_pts, axis=0)
        order = loop if nrm @ ref < 0 else loop[::-1]
        for i in range(1, len(order) - 1):
            tris.append((order[0], order[i], order[i + 1]))
    assert len(tris) <= 5, (case, len(tris))
    return tris


def build_tables() -> dict:
    """{TRI_TABLE, TRI_COUNT, EDGE_BASE, EDGE_AXIS} as int32 arrays."""
    tri_table = np.full((256, 5, 3), -1, dtype=np.int32)
    tri_count = np.zeros(256, dtype=np.int32)
    for case in range(256):
        tris = build_case(case)
        tri_count[case] = len(tris)
        for i, t in enumerate(tris):
            tri_table[case, i] = t
    return dict(
        TRI_TABLE=tri_table, TRI_COUNT=tri_count,
        EDGE_BASE=np.array([b for b, _ in EDGES], dtype=np.int32),
        EDGE_AXIS=np.array([a for _, a in EDGES], dtype=np.int32))
