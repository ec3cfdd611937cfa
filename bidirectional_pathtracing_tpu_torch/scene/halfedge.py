"""Faithful replication of the reference's halfedge vertex normals.

The reference builds a halfedge mesh from each polygon soup
(HalfedgeMesh::build, reference src/util/halfEdgeMesh.cpp:29-404) and
computes per-vertex normals with Vertex::computeNormal
(halfEdgeMesh.h:487-515).  Crucially, computeNormal takes a DIFFERENT walk
for boundary vertices, starting from the vertex's halfedge pointer — which
build() leaves pointing at a boundary-loop halfedge for boundary vertices.
For fully-open meshes (e.g. every Cornell-box wall is a lone quad/tri pair)
this walk reverses the winding orientation, flipping the normals INTO the
box.  The renderer's one-sided diffuse BSDF (bsdf.cpp:56-58) only works
because of this flip, so we replicate the walk exactly rather than using
plain area-weighted winding normals.

This is a host-side, per-scene-load computation (numpy + dicts); large
meshes can later route through the C++ scene builder.

A copy of bidirectional_pathtracing_tpu/scene/halfedge.py (:24-140), kept
jax-free.
"""

from __future__ import annotations

import numpy as np


def compute_vertex_normals(positions: np.ndarray, polygons) -> np.ndarray:
    """positions: [V,3]; polygons: list of index lists.  Returns [V,3] unit
    normals, matching HalfedgeMesh::build + Vertex::computeNormal."""
    V = positions.shape[0]

    # --- build real halfedges (creation order = face loop order) ----------
    nxt, twin, vert, face_of = [], [], [], []
    face_is_boundary = []
    pair_to_he = {}
    v_halfedge = [-1] * V

    for f, poly in enumerate(polygons):
        d = len(poly)
        face_is_boundary.append(False)
        base = len(vert)
        for i in range(d):
            a, b = int(poly[i]), int(poly[(i + 1) % d])
            if (a, b) in pair_to_he:
                raise ValueError("non-manifold or inconsistently oriented mesh")
            hid = len(vert)
            pair_to_he[(a, b)] = hid
            vert.append(a)
            face_of.append(f)
            nxt.append(-1)
            twin.append(-1)
            v_halfedge[a] = hid          # last-created outgoing halfedge wins
            if (b, a) in pair_to_he:
                other = pair_to_he[(b, a)]
                twin[hid] = other
                twin[other] = hid
        for i in range(d):
            nxt[base + i] = base + (i + 1) % d

    n_real = len(vert)

    # --- advance boundary vertices' halfedge to a twinless one ------------
    for v in range(V):
        if v_halfedge[v] < 0:
            continue
        h0 = v_halfedge[v]
        h = h0
        while True:
            if twin[h] == -1:
                v_halfedge[v] = h
                break
            h = nxt[twin[h]]
            if h == h0:
                break

    # --- construct boundary loops (halfEdgeMesh.cpp:250-316) --------------
    for h in range(n_real):
        if twin[h] != -1:
            continue
        bface = len(face_is_boundary)
        face_is_boundary.append(True)
        loop = []
        i = h
        while True:
            t = len(vert)
            loop.append(t)
            vert.append(vert[nxt[i]])
            face_of.append(bface)
            nxt.append(-1)
            twin.append(i)
            twin[i] = t
            i = nxt[i]
            while i != h and twin[i] != -1:
                i = nxt[twin[i]]
            if i == h:
                break
        deg = len(loop)
        for p in range(deg):
            nxt[loop[p]] = loop[(p - 1) % deg]

    # --- final vertex->halfedge advance (halfEdgeMesh.cpp:327-331) --------
    for v in range(V):
        if v_halfedge[v] >= 0:
            v_halfedge[v] = nxt[twin[v_halfedge[v]]]

    # --- computeNormal (halfEdgeMesh.h:487-515) ----------------------------
    normals = np.zeros_like(positions)
    for v in range(V):
        h0 = v_halfedge[v]
        if h0 < 0:
            continue
        # Vertex::isBoundary (halfEdgeMesh.h:532-545)
        is_boundary = False
        h = h0
        while True:
            if face_is_boundary[face_of[h]]:
                is_boundary = True
                break
            h = nxt[twin[h]]
            if h == h0:
                break
        pi = positions[v]
        n = np.zeros(3)
        h = h0
        if is_boundary:
            while True:
                pj = positions[vert[nxt[h]]]
                pk = positions[vert[nxt[nxt[h]]]]
                n += np.cross(pj - pi, pk - pi)
                h = twin[nxt[h]]
                if h == h0:
                    break
        else:
            while True:
                pj = positions[vert[nxt[h]]]
                pk = positions[vert[nxt[nxt[h]]]]
                n += np.cross(pj - pi, pk - pi)
                h = nxt[twin[h]]
                if h == h0:
                    break
        ln = np.linalg.norm(n)
        normals[v] = n / ln if ln > 1e-20 else n
    return normals
