"""Editable halfedge mesh with working local ops and resampling.

The reference ships the full halfedge data structure
(src/util/halfEdgeMesh.{h,cpp}) but leaves every edit operation as an
unimplemented TODO stub (src/application/meshEdit.cpp:6-50:
HalfedgeMesh::{flipEdge,splitEdge,collapseEdge} and
MeshResampler::{upsample,downsample,resample} all return immediately).
This module provides the same API with working implementations:

  - flip_edge / split_edge / collapse_edge  local triangle-mesh ops
  - upsample    Loop subdivision
  - downsample  quadric-error-metric edge-collapse simplification
  - resample    isotropic remeshing (split/collapse/flip/smooth rounds)

Host-side preprocessing (plain Python/numpy), like the reference's: the
renderer consumes only the flattened triangle arrays via to_arrays().
Halfedge convention matches the reference: a halfedge stores its SOURCE
vertex; boundary loops are explicit faces with is_boundary=True
(halfEdgeMesh.cpp:250-316).

A copy of bidirectional_pathtracing_tpu/scene/meshedit.py (:21-734), kept
jax-free: scene/build.py applies its upsample / downsample / resample to
every mesh of a loaded scene (the CLI's --upsample / --downsample /
--resample).  The viewer's key bindings for the edit operations are not
ported."""

from __future__ import annotations

import numpy as np


class _Elem:
    __slots__ = ("halfedge", "id", "removed")

    def __init__(self):
        self.halfedge = None
        self.id = -1
        self.removed = False


class Vertex(_Elem):
    __slots__ = ("position", "is_new", "new_position")

    def __init__(self, position):
        super().__init__()
        self.position = np.asarray(position, np.float64).copy()
        self.is_new = False
        self.new_position = None

    def degree(self) -> int:
        return sum(1 for _ in self.outgoing())

    def outgoing(self):
        h = self.halfedge
        while True:
            yield h
            h = h.twin.next
            if h is self.halfedge:
                return

    def neighbors(self):
        for h in self.outgoing():
            yield h.twin.vertex

    def is_boundary(self) -> bool:
        return any(h.face.is_boundary for h in self.outgoing())

    def normal(self) -> np.ndarray:
        n = np.zeros(3)
        p = self.position
        for h in self.outgoing():
            if h.face.is_boundary:
                continue
            a = h.twin.vertex.position - p
            b = h.next.twin.vertex.position - p
            n += np.cross(a, b)
        ln = np.linalg.norm(n)
        return n / ln if ln > 1e-20 else n


class Edge(_Elem):
    __slots__ = ("is_new",)

    def __init__(self):
        super().__init__()
        self.is_new = False

    def is_boundary(self) -> bool:
        return (self.halfedge.face.is_boundary
                or self.halfedge.twin.face.is_boundary)

    def length(self) -> float:
        return float(np.linalg.norm(
            self.halfedge.vertex.position
            - self.halfedge.twin.vertex.position))


class Face(_Elem):
    __slots__ = ("is_boundary",)

    def __init__(self, is_boundary=False):
        super().__init__()
        self.is_boundary = is_boundary

    def vertices(self):
        h = self.halfedge
        while True:
            yield h.vertex
            h = h.next
            if h is self.halfedge:
                return

    def degree(self) -> int:
        return sum(1 for _ in self.vertices())

    def centroid(self) -> np.ndarray:
        vs = list(self.vertices())
        return sum(v.position for v in vs) / len(vs)

    def normal(self) -> np.ndarray:
        vs = [v.position for v in self.vertices()]
        n = np.cross(vs[1] - vs[0], vs[2] - vs[0])
        ln = np.linalg.norm(n)
        return n / ln if ln > 1e-20 else n


class Halfedge(_Elem):
    __slots__ = ("twin", "next", "vertex", "edge", "face")

    def __init__(self):
        super().__init__()
        self.twin = None
        self.next = None
        self.vertex = None   # SOURCE vertex (reference convention)
        self.edge = None
        self.face = None


class HalfedgeMesh:
    """Pointer-based halfedge mesh (same shape as the reference's)."""

    def __init__(self):
        self.vertices: list[Vertex] = []
        self.edges: list[Edge] = []
        self.faces: list[Face] = []        # includes boundary faces
        self.halfedges: list[Halfedge] = []

    # ---- construction (HalfedgeMesh::build, halfEdgeMesh.cpp:29-404) ----
    @classmethod
    def build(cls, positions, polygons) -> "HalfedgeMesh":
        m = cls()
        positions = np.asarray(positions, np.float64)
        m.vertices = [Vertex(p) for p in positions]
        pair = {}
        for poly in polygons:
            d = len(poly)
            f = Face()
            m.faces.append(f)
            hs = []
            for i in range(d):
                a, b = int(poly[i]), int(poly[(i + 1) % d])
                if (a, b) in pair:
                    raise ValueError("non-manifold or inconsistent winding")
                h = Halfedge()
                m.halfedges.append(h)
                pair[(a, b)] = h
                h.vertex = m.vertices[a]
                h.face = f
                m.vertices[a].halfedge = h
                if (b, a) in pair:
                    t = pair[(b, a)]
                    h.twin = t
                    t.twin = h
                    h.edge = t.edge
                else:
                    e = Edge()
                    m.edges.append(e)
                    h.edge = e
                    e.halfedge = h
                hs.append((h, a, b))
            for i in range(d):
                hs[i][0].next = hs[(i + 1) % d][0]
            f.halfedge = hs[0][0]
        # boundary loops
        for h in list(m.halfedges):
            if h.twin is not None:
                continue
            bf = Face(is_boundary=True)
            m.faces.append(bf)
            loop = []
            i = h
            while True:
                t = Halfedge()
                m.halfedges.append(t)
                loop.append(t)
                t.vertex = i.next.vertex
                t.face = bf
                t.twin = i
                t.edge = i.edge
                i.twin = t
                i = i.next
                while i is not h and i.twin is not None:
                    i = i.twin.next
                if i is h:
                    break
            for p in range(len(loop)):
                loop[p].next = loop[p - 1]
            bf.halfedge = loop[0]
        # boundary vertices point at a boundary halfedge is not required
        # here (normals live in halfedge.py); keep creation-order pointers.
        return m

    @classmethod
    def from_arrays(cls, positions, triangles) -> "HalfedgeMesh":
        return cls.build(positions, [list(t) for t in np.asarray(triangles)])

    def to_arrays(self):
        """(positions [V,3], triangles [T,3]) of the live interior faces;
        non-triangle faces are fanned."""
        self.compact()
        idx = {v: i for i, v in enumerate(self.vertices)}
        pos = np.array([v.position for v in self.vertices], np.float64)
        tris = []
        for f in self.faces:
            if f.is_boundary:
                continue
            vs = [idx[v] for v in f.vertices()]
            for k in range(1, len(vs) - 1):
                tris.append((vs[0], vs[k], vs[k + 1]))
        return pos, np.array(tris, np.int64).reshape(-1, 3)

    def compact(self):
        self.vertices = [v for v in self.vertices if not v.removed]
        self.edges = [e for e in self.edges if not e.removed]
        self.faces = [f for f in self.faces if not f.removed]
        self.halfedges = [h for h in self.halfedges if not h.removed]

    # ---- global queries ----
    def n_vertices(self):
        return sum(1 for v in self.vertices if not v.removed)

    def n_edges(self):
        return sum(1 for e in self.edges if not e.removed)

    def n_faces(self, include_boundary=False):
        return sum(1 for f in self.faces if not f.removed
                   and (include_boundary or not f.is_boundary))

    def euler_characteristic(self) -> int:
        return self.n_vertices() - self.n_edges() + self.n_faces()

    def validate(self):
        """Connectivity invariants (the reference's printed consistency
        checks, done as assertions)."""
        for h in self.halfedges:
            if h.removed:
                continue
            assert h.twin.twin is h
            assert not h.twin.removed and not h.next.removed
            assert h.edge is h.twin.edge
            assert not h.vertex.removed and not h.edge.removed \
                and not h.face.removed
            assert h.next.face is h.face
            # twin's source is this halfedge's destination
            assert h.twin.vertex is h.next.vertex
        for v in self.vertices:
            if v.removed:
                continue
            assert v.halfedge.vertex is v and not v.halfedge.removed
            deg = 0
            for _ in v.outgoing():
                deg += 1
                assert deg < 10000, "broken vertex ring"
        for e in self.edges:
            if e.removed:
                continue
            assert e.halfedge.edge is e and not e.halfedge.removed
        for f in self.faces:
            if f.removed:
                continue
            assert f.halfedge.face is f and not f.halfedge.removed
            deg = 0
            h = f.halfedge
            while True:
                deg += 1
                assert deg < 100000, "broken face loop"
                h = h.next
                if h is f.halfedge:
                    break
            if not f.is_boundary:
                assert deg >= 3

    # ---- local edit ops (reference API: meshEdit.cpp stubs) ----
    def flip_edge(self, e: Edge):
        """Rotate an interior edge inside its two triangles
        (HalfedgeMesh::flipEdge, meshEdit.cpp:12-17 stub).  Boundary edges
        are a no-op (returns None), like the assignment spec."""
        if e.is_boundary():
            return None
        h = e.halfedge
        t = h.twin
        f0, f1 = h.face, t.face
        if f0.degree() != 3 or f1.degree() != 3:
            return None
        # vertices: h: a->b; triangle 0 = a,b,c; triangle 1 = b,a,d
        a, b = h.vertex, t.vertex
        h1, h2 = h.next, h.next.next          # b->c, c->a
        t1, t2 = t.next, t.next.next          # a->d, d->b
        c, d = h2.vertex, t2.vertex
        # degree-3 guard: flipping would detach a or b
        if sum(1 for _ in a.outgoing()) == 3 and not a.is_boundary():
            return None
        if sum(1 for _ in b.outgoing()) == 3 and not b.is_boundary():
            return None
        if c is d:
            return None
        # already an edge c-d? flipping would create a duplicate edge
        for nb in c.neighbors():
            if nb is d:
                return None
        # rebuild both triangle cycles with the rotated diagonal:
        # (a,b,c) + (b,a,d) become (c,d,b) + (d,c,a)
        h.vertex = c
        t.vertex = d
        # f0 cycle: h (c->d), t2 (d->b), h1 (b->c)
        h.next = t2
        t2.next = h1
        h1.next = h
        # f1 cycle: t (d->c), h2 (c->a), t1 (a->d)
        t.next = h2
        h2.next = t1
        t1.next = t
        for x in (h, t2, h1):
            x.face = f0
        for x in (t, h2, t1):
            x.face = f1
        f0.halfedge = h
        f1.halfedge = t
        # fix vertex halfedge pointers that may have pointed at h or t
        a.halfedge = t1
        b.halfedge = h1
        c.halfedge = h
        d.halfedge = t
        return e

    def split_edge(self, e: Edge):
        """Split an edge at its midpoint (HalfedgeMesh::splitEdge,
        meshEdit.cpp:19-24 stub).  Interior: 2 triangles -> 4.  Boundary:
        the interior triangle -> 2 and the boundary loop grows by one.
        Returns the new Vertex (is_new=True); the two half-edges of the
        original edge keep is_new=False, cross edges get is_new=True (the
        marking Loop subdivision needs)."""
        h = e.halfedge
        if h.face.is_boundary:
            h = h.twin
        t = h.twin
        if h.face.degree() != 3 or (not t.face.is_boundary
                                    and t.face.degree() != 3):
            return None
        a, b = h.vertex, t.vertex
        m = Vertex((a.position + b.position) * 0.5)
        m.is_new = True
        self.vertices.append(m)

        h1, h2 = h.next, h.next.next          # b->c, c->a
        c = h2.vertex
        # new elements for the interior side of h
        e_mb = Edge()                          # second half of e (m-b)
        e_mc = Edge()
        e_mc.is_new = True
        self.edges.extend([e_mb, e_mc])
        f_mbc = Face()
        self.faces.append(f_mbc)
        h_mb = Halfedge()   # m->b (face f_mbc); its twin comes from the
        h_mc = Halfedge()   # other side (t_bm / boundary t_bm) below
        h_cm = Halfedge()
        self.halfedges.extend([h_mb, h_mc, h_cm])
        # triangle (a, m, c): reuse h (a->m), new h_mc (m->c), h2 (c->a)
        # triangle (m, b, c): h_mb (m->b), h1 (b->c), h_cm (c->m)
        h.twin = None  # will fix
        # a->m
        h.vertex = a
        h.next = h_mc
        h_mc.next = h2
        h2.next = h
        h_mc.vertex = m
        h_mc.edge = e_mc
        h_mc.face = h.face
        h_mc.twin = h_cm
        h_cm.twin = h_mc
        h.face.halfedge = h
        # m->b triangle
        h_mb.vertex = m
        h_mb.edge = e_mb
        h_mb.face = f_mbc
        h_mb.next = h1
        h1.face = f_mbc
        h1.next = h_cm
        h_cm.vertex = c
        h_cm.edge = e_mc
        h_cm.face = f_mbc
        h_cm.next = h_mb
        f_mbc.halfedge = h_mb
        e_mb.halfedge = h_mb
        e_mc.halfedge = h_mc
        m.halfedge = h_mb

        if t.face.is_boundary:
            # extend the boundary loop: t was b->a; becomes b->m then m->a
            t_bm = Halfedge()
            self.halfedges.append(t_bm)
            # find predecessor of t in the boundary loop
            prev = t
            while prev.next is not t:
                prev = prev.next
            t_bm.vertex = b
            t_bm.edge = e_mb
            t_bm.face = t.face
            prev.next = t_bm
            t_bm.next = t
            t.vertex = m
            # twins: h (a->m) <-> t (m->a); h_mb (m->b) <-> t_bm (b->m)
            h.twin = t
            t.twin = h
            h_mb.twin = t_bm
            t_bm.twin = h_mb
            e_mb.is_new = False
            # edge assignments: e stays on (a,m) side
            t.edge = e
            e.halfedge = h
        else:
            # full interior split: also split triangle (b, a, d)
            t1, t2 = t.next, t.next.next      # a->d, d->b
            d = t2.vertex
            e_md = Edge()
            e_md.is_new = True
            self.edges.append(e_md)
            f_mbd = Face()
            self.faces.append(f_mbd)
            t_md = Halfedge()
            t_dm = Halfedge()
            t_bm = Halfedge()
            self.halfedges.extend([t_md, t_dm, t_bm])
            # triangle (m, a, d): t (m->a), t1 (a->d), t_dm (d->m)
            t.vertex = m
            t.next = t1
            t1.next = t_dm
            t_dm.next = t
            t_dm.vertex = d
            t_dm.edge = e_md
            t_dm.face = t.face
            t.face.halfedge = t
            # triangle (b, m, d): t_bm (b->m), t_md (m->d), t2 (d->b)
            t_bm.vertex = b
            t_bm.edge = e_mb
            t_bm.face = f_mbd
            t_bm.next = t_md
            t_md.vertex = m
            t_md.edge = e_md
            t_md.face = f_mbd
            t_md.next = t2
            t2.face = f_mbd
            t2.next = t_bm
            f_mbd.halfedge = t_bm
            e_md.halfedge = t_md
            t_md.twin = t_dm
            t_dm.twin = t_md
            # twins across the original edge halves
            h.twin = t
            t.twin = h
            h_mb.twin = t_bm
            t_bm.twin = h_mb
            t.edge = e
            e.halfedge = h
            e_mb.is_new = False
            b.halfedge = t_bm
            d.halfedge = t_dm
        a.halfedge = h
        b.halfedge = h1
        return m

    def collapse_edge(self, e: Edge):
        """Collapse an edge to its midpoint (HalfedgeMesh::collapseEdge,
        meshEdit.cpp:26-31 stub).  Refuses collapses that would produce a
        non-manifold mesh (link condition).  Returns the surviving Vertex
        or None."""
        h = e.halfedge
        t = h.twin
        a, b = h.vertex, t.vertex
        # link condition: shared neighbors of a and b must be exactly the
        # opposite vertices of the (1 or 2) incident triangles
        na = set(id(v) for v in a.neighbors())
        nb = set(id(v) for v in b.neighbors())
        allowed = set()
        if not h.face.is_boundary and h.face.degree() == 3:
            allowed.add(id(h.next.next.vertex))
        if not t.face.is_boundary and t.face.degree() == 3:
            allowed.add(id(t.next.next.vertex))
        if (na & nb) != allowed:
            return None
        # face-count guard: a closed mesh needs >= 4 faces after the
        # collapse (a tetrahedron passes the link condition but would
        # degenerate to 2 coincident faces)
        faces_removed = len(allowed)
        closed = not any(f.is_boundary for f in self.faces if not f.removed)
        min_faces = 4 if closed else 1
        if self.n_faces() - faces_removed < min_faces:
            return None

        mid = (a.position + b.position) * 0.5

        def remove_tri(hh):
            """Remove the triangle on hh's side by fusing its two other
            edges into one."""
            f = hh.face
            h1, h2 = hh.next, hh.next.next     # b->c, c->a (for h side)
            o1, o2 = h1.twin, h2.twin
            e_keep = h1.edge
            e_drop = h2.edge
            # fuse: o1 <-> o2 become twins over e_keep
            o1.twin = o2
            o2.twin = o1
            o2.edge = e_keep
            e_keep.halfedge = o1
            c = h2.vertex
            c.halfedge = o1          # o1 sources at c (twin of b->c)
            e_drop.removed = True
            h1.removed = True
            h2.removed = True
            f.removed = True
            return o1, o2

        # collect both rings before surgery (b's halfedges re-source to a;
        # the union provides the surviving a.halfedge candidate)
        b_out = [x for x in b.outgoing()]
        a_out = [x for x in a.outgoing()]

        if not h.face.is_boundary and h.face.degree() == 3:
            remove_tri(h)
        else:
            # n-gon or boundary face: just unlink h from its loop
            prev = h
            while prev.next is not h:
                prev = prev.next
            prev.next = h.next
            if h.face.halfedge is h:
                h.face.halfedge = h.next
            h.removed = True
        if not t.face.is_boundary and t.face.degree() == 3:
            remove_tri(t)
        else:
            prev = t
            while prev.next is not t:
                prev = prev.next
            prev.next = t.next
            if t.face.halfedge is t:
                t.face.halfedge = t.next
            t.removed = True
        h.removed = True
        t.removed = True
        e.removed = True

        # re-source every halfedge leaving b to a
        for x in b_out:
            if not x.removed and x.vertex is b:
                x.vertex = a
        b.removed = True
        a.position = mid
        for x in a_out + b_out:
            if not x.removed and x.vertex is a:
                a.halfedge = x
                break
        return a

    # ---- resampling (MeshResampler stubs, meshEdit.cpp:33-50) ----
    def upsample(self):
        """Loop subdivision (MeshResampler::upsample stub).  Triangle
        meshes only."""
        # 1. new positions for old vertices
        for v in self.vertices:
            if v.removed:
                continue
            v.is_new = False
            if v.is_boundary():
                nbrs = [nb.position for hh in v.outgoing()
                        if hh.edge.is_boundary()
                        for nb in (hh.twin.vertex,)]
                if len(nbrs) >= 2:
                    v.new_position = 0.75 * v.position \
                        + 0.125 * (nbrs[0] + nbrs[1])
                else:
                    v.new_position = v.position.copy()
            else:
                nbrs = [nb.position for nb in v.neighbors()]
                n = len(nbrs)
                u = 3.0 / 16.0 if n == 3 else 3.0 / (8.0 * n)
                v.new_position = (1 - n * u) * v.position \
                    + u * sum(nbrs)
        # 2. positions for edge midpoints
        edge_pos = {}
        old_edges = [ed for ed in self.edges if not ed.removed]
        for ed in old_edges:
            ed.is_new = False
            hh = ed.halfedge
            aa = hh.vertex.position
            bb = hh.twin.vertex.position
            if ed.is_boundary():
                edge_pos[id(ed)] = 0.5 * (aa + bb)
            else:
                cc = hh.next.next.vertex.position
                dd = hh.twin.next.next.vertex.position
                edge_pos[id(ed)] = 0.375 * (aa + bb) + 0.125 * (cc + dd)
        # 3. split every old edge
        for ed in old_edges:
            m = self.split_edge(ed)
            if m is not None:
                m.new_position = edge_pos[id(ed)]
        # 4. flip new edges connecting old<->new
        for ed in [x for x in self.edges if not x.removed and x.is_new]:
            va = ed.halfedge.vertex
            vb = ed.halfedge.twin.vertex
            if va.is_new != vb.is_new:
                self.flip_edge(ed)
        # 5. apply positions
        for v in self.vertices:
            if not v.removed and v.new_position is not None:
                v.position = v.new_position
                v.new_position = None
        self.compact()

    def downsample(self, target_faces: int | None = None):
        """Quadric-error-metric simplification
        (MeshResampler::downsample stub): collapse minimum-cost edges until
        the face count reaches target (default faces/4).

        Edges of equal cost go in the order of self.edges (each edge's
        `id` is its index there).  The JAX package breaks such ties by
        the builtin id(), a memory address, so its result on a mesh with
        tied costs (a flat grid, the icosahedron) changes from run to run;
        with that one order it computes the same mesh."""
        self.compact()
        for i, ed in enumerate(self.edges):
            ed.id = i
        if target_faces is None:
            target_faces = max(self.n_faces() // 4, 4)

        def vertex_quadric(v):
            q = np.zeros((4, 4))
            for hh in v.outgoing():
                f = hh.face
                if f.is_boundary:
                    continue
                n = f.normal()
                d = -np.dot(n, v.position)
                p = np.append(n, d)
                q += np.outer(p, p)
            return q

        quadrics = {id(v): vertex_quadric(v)
                    for v in self.vertices if not v.removed}

        def edge_cost(ed):
            va, vb = ed.halfedge.vertex, ed.halfedge.twin.vertex
            q = quadrics[id(va)] + quadrics[id(vb)]
            a3 = q[:3, :3]
            b3 = -q[:3, 3]
            try:
                x = np.linalg.solve(a3 + 1e-9 * np.eye(3), b3)
            except np.linalg.LinAlgError:
                x = 0.5 * (va.position + vb.position)
            p = np.append(x, 1.0)
            return float(p @ q @ p), x

        import heapq
        heap = []
        stamp = {}
        for ed in self.edges:
            if ed.removed:
                continue
            c, x = edge_cost(ed)
            stamp[ed.id] = 0
            heapq.heappush(heap, (c, ed.id, 0, ed, x))

        while self.n_faces() > target_faces and heap:
            c, _, s, ed, x = heapq.heappop(heap)
            if ed.removed or stamp.get(ed.id, -1) != s:
                continue
            va, vb = ed.halfedge.vertex, ed.halfedge.twin.vertex
            qsum = quadrics[id(va)] + quadrics[id(vb)]
            v = self.collapse_edge(ed)
            if v is None:
                continue
            v.position = x
            quadrics[id(v)] = qsum
            for hh in v.outgoing():
                ee = hh.edge
                if ee.removed:
                    continue
                cc, xx = edge_cost(ee)
                s2 = stamp.get(ee.id, 0) + 1
                stamp[ee.id] = s2
                heapq.heappush(heap, (cc, ee.id, s2, ee, xx))
        self.compact()

    def resample(self, iterations: int = 3):
        """Isotropic remeshing (MeshResampler::resample stub): split long
        edges, collapse short ones, flip for valence, tangential smooth."""
        self.compact()
        mean = np.mean([e.length() for e in self.edges
                        if not e.removed]) if self.edges else 0.0
        if mean == 0.0:
            return
        for _ in range(iterations):
            for e in [x for x in self.edges if not x.removed]:
                if e.length() > 4.0 * mean / 3.0:
                    self.split_edge(e)
            for e in [x for x in self.edges if not x.removed]:
                if not e.removed and e.length() < 0.8 * mean:
                    self.collapse_edge(e)
            for e in [x for x in self.edges if not x.removed]:
                if e.is_boundary():
                    continue
                hh = e.halfedge
                va, vb = hh.vertex, hh.twin.vertex
                vc = hh.next.next.vertex
                vd = hh.twin.next.next.vertex
                def dev(v, delta=0):
                    tgt = 4 if v.is_boundary() else 6
                    return abs(v.degree() + delta - tgt)
                before = dev(va) + dev(vb) + dev(vc) + dev(vd)
                after = dev(va, -1) + dev(vb, -1) + dev(vc, 1) + dev(vd, 1)
                if after < before:
                    self.flip_edge(e)
            # tangential smoothing
            for _ in range(5):
                moves = []
                for v in self.vertices:
                    if v.removed or v.is_boundary():
                        continue
                    c = sum(nb.position for nb in v.neighbors()) \
                        / max(v.degree(), 1)
                    d = c - v.position
                    n = v.normal()
                    d = d - np.dot(d, n) * n
                    moves.append((v, v.position + 0.2 * d))
                for v, p in moves:
                    v.position = p
        self.compact()
