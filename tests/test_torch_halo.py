"""The strip source of K1 and K2 (``fsr_tpu_torch/kernels/halo.py``: H1 folded
into the kernels) and the captured row-sharded call's order across devices,
on the CPU.

A row strip's kernel reads its halo rows in place from its neighbours' rows,
the counterpart of ``fsr_tpu/parallel/spatial.py:_exchange_halo``
(``lax.ppermute`` + ``jnp.where`` + ``concatenate`` inside each shard's
body).  Held here:

- the plain version of the strip read (``halo.halo_rows_reference`` over
  own-row buffers, what K1's and K2's wrappers run for a CPU strip)
  bit-equal to the rows of ``parallel.spatial._exchange_halo``'s
  ``torch.cat`` for 2, 3, 4 and 8 strips, uint8 / bfloat16 / float32, RGB
  and RGBA, a batch and dp x sp frame groups, with the neighbours' whole
  buffers and with only their edge rows, and no launch counted;
- every strip of a ``CapturedSpatial`` call on a mesh of CPU devices, read
  by that plain version over the call's own-row buffers, bit-equal to JAX's
  ``_exchange_halo`` run under ``shard_map`` on the conftest's 8 virtual CPU
  devices, shard by shard;
- the eager call handing each strip's kernel views of the input's shards,
  with no copy and no ``torch.cat`` of a strip's rows;
- the wrappers' checks of a strip source (``halo.check``), one refusal per
  part the kernels do not take (the card faked by a monkeypatch), and the
  strides it lays out for the kernels;
- the event schedule (``spatial._schedule``'s write, stage and replay
  steps over ``spatial._reads``, which names only the neighbours: each
  card reads the frame from its own static) on 2, 3 and 4 cards and dp x
  sp, over queues of three calls: ``put`` + call, ``writable()`` + a
  producer's writes + call, and a mix with a call that writes nothing;
  every read of a buffer comes after that call's write of it and before
  the next write (and a schedule without either kind of wait is caught);
- a mesh whose cards lack peer access raising ``ValueError`` at
  construction, naming the pair (the peer query monkeypatched), and the
  pairs that construction enables.

The strip-source kernels run only on the card: ``chip_smoke.py`` phase 18
holds them bit-equal to the same kernels on the ``torch.cat``'d strips there.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from fsr_tpu.parallel import sharding as jsharding
from fsr_tpu.parallel import spatial as jspatial

from fsr_tpu_torch.kernels import halo
from fsr_tpu_torch.parallel import Sharded, sharding, spatial

CPU = torch.device("cpu")
DTYPES = {"u8": torch.uint8, "bf16": torch.bfloat16, "f32": torch.float32}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread, as tests/test_torch_sharded_capture.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(seed, dtype, shape):
    x = torch.from_numpy(np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32))
    return (x * 255).to(torch.uint8) if dtype == torch.uint8 else x.to(dtype)


def _strips(x, n, groups):
    """``x``'s row strips, frame group by frame group (dp x sp: the batch
    split into ``groups``), in ``Sharded.shards``' order."""
    return [s for g in x.chunk(groups, 0) for s in g.chunk(n, -2)]


# --- the plain version against the exchange ---------------------------------------


@pytest.mark.parametrize("layout", ["batch", "dp x sp"])
@pytest.mark.parametrize("channels", [3, 4], ids=["RGB", "RGBA"])
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_plain_halo_rows_equal_the_exchange(n, dtype, channels, layout):
    """Own-row buffers holding each strip's rows: the plain strip read of
    each strip (its neighbours' whole buffers, or only their edge rows, as
    the eager call sends them between cards) equals that strip's
    ``_exchange_halo`` ``torch.cat``, and no launch is counted."""
    from fsr_tpu_torch.kernels import easu_gather, fused

    groups = 2 if layout == "dp x sp" else 1
    for halo_n, width in ((spatial._HALO, 11), (spatial._GHALO, 16)):
        h = halo_n + 1
        x = _frames(n + channels, DTYPES[dtype], (2 * groups, channels, n * h, width))
        strips = _strips(x, n, groups)
        fused.upscale_padded.launches = easu_gather.easu_gather.launches = 0
        for g in range(groups):
            group = strips[g * n:(g + 1) * n]
            want = spatial._exchange_halo(group, halo_n)
            bufs = [s.clone() for s in group]
            for k in range(n):
                for edges in (False, True):
                    up = bufs[k - 1][..., -halo_n:, :].clone() if edges and k else (bufs[k - 1] if k else None)
                    down = (bufs[k + 1][..., :halo_n, :].clone() if edges and k + 1 < n
                            else (bufs[k + 1] if k + 1 < n else None))
                    got = halo.halo_rows_reference(halo.StripSource(up, bufs[k], down, halo_n))
                    assert got.shape == halo.StripSource(up, bufs[k], down, halo_n).shape
                    assert torch.equal(got, want[k]), f"{n} strips, halo {halo_n}, group {g}: strip {k}, edges {edges}"
        assert fused.upscale_padded.launches == easu_gather.easu_gather.launches == 0


# --- the wrappers' checks of a strip source -----------------------------------------


def _source(**change):
    """A strip source the kernels take: (2, 3, 6, 16) float32 own rows between
    whole neighbours, with one part replaced from ``change``."""
    own = torch.zeros((2, 3, 6, 16))
    parts = dict(up=torch.zeros((2, 3, 6, 16)), own=own, down=torch.zeros((2, 3, 6, 16)), halo=4)
    parts.update(change)
    return halo.StripSource(**parts)


REFUSED = {
    "dtype": (dict(up=torch.zeros((2, 3, 6, 16), dtype=torch.bfloat16)), "up part is torch.bfloat16"),
    "width": (dict(down=torch.zeros((2, 3, 6, 17))), "down part is 17 wide"),
    "channels": (dict(up=torch.zeros((2, 4, 6, 16))), "up part has 4 channels"),
    "frames": (dict(down=torch.zeros((1, 3, 6, 16))), "down part has frames"),
    "too few rows": (dict(up=torch.zeros((2, 3, 3, 16))), "up part holds 3 rows"),
    "non-contiguous rows": (dict(down=torch.zeros((2, 3, 6, 32))[..., ::2]), "down part needs rows of 16 contiguous"),
    "frames of two strides": (dict(own=torch.zeros((2, 2, 3, 6, 16)).transpose(0, 1),
                                   up=torch.zeros((2, 2, 3, 6, 16)), down=None), "own part needs rows"),
    "a CPU part on a CUDA launch": (dict(down=torch.zeros((2, 3, 6, 16))), "down part lies on cpu"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_strip_source_refused_before_a_launch(case, monkeypatch):
    """``halo.check``, which K1's and K2's wrappers run before a strip-source
    launch, refuses each part they do not take with a ``ValueError`` naming
    it.  The card is faked: every part but a CPU one "lies on a card"."""
    change, message = REFUSED[case]
    src = _source(**change)
    cpu_part = src.down if case == "a CPU part on a CUDA launch" else None
    monkeypatch.setattr(halo, "_on_card", lambda t: t is not cpu_part)
    with pytest.raises(ValueError, match=message):
        halo.check(src)


def test_strip_source_taken_and_laid_out(monkeypatch):
    """A source of views (own rows of a larger frame, an edge-rows part, two
    leading dimensions of one stride) and a neighbour on a peer card pass
    ``halo.check``, which gives each part's pointer, plane and frame strides
    and rows, as ``csrc/fsr_pixel.cuh:StripParts`` reads them; a neighbour on
    a card this card cannot read is refused."""
    monkeypatch.setattr(halo, "_on_card", lambda t: True)
    frame = torch.zeros((2, 3, 24, 16))
    src = halo.StripSource(frame[..., 0:6, :], frame[..., 6:12, :], frame[..., 12:16, :].clone(), 4)
    parts = halo.check(src)
    assert list(parts.plane) == [24 * 16, 24 * 16, 4 * 16] and list(parts.frame) == [3 * 24 * 16] * 2 + [3 * 4 * 16]
    assert list(parts.rows) == [6, 6, 4] and parts.halo == 4
    assert parts.ptr[1] - parts.ptr[0] == 6 * 16 * 4 and src.shape == (2, 3, 14, 16)
    top = halo.check(halo.StripSource(None, frame[0, :, :6, :], frame[0, :, 6:10, :], 4))
    assert top.ptr[0] is None and top.frame[1] == 0 and top.plane[1] == 24 * 16
    batch = torch.zeros((2, 1, 3, 3, 10, 16))[:, :, :, :, 2:8, :]  # frames (2, 1, 3) of one stride
    assert halo.check(halo.StripSource(None, batch, None, 4)).frame[1] == 3 * 10 * 16

    class Card:  # a part on another card, as check sees it
        def __init__(self, t, index):
            self.t, self.device = t, torch.device("cuda", index)

        def __getattr__(self, name):
            return getattr(self.t, name)

    own = Card(torch.zeros((3, 6, 16)), 0)
    for readable in (True, False):
        monkeypatch.setattr(halo, "can_access_peer", lambda a, b, readable=readable: readable)
        src = halo.StripSource(Card(torch.zeros((3, 6, 16)), 1), own, None, 4)
        if readable:
            halo.check(src)
        else:
            with pytest.raises(ValueError, match="up part lies on cuda:1, which cuda:0 cannot read"):
                halo.check(src)


# --- the eager call reads its shards in place ----------------------------------------


@pytest.mark.parametrize("ratio", ["2x K1", "1.5x K2"])
@pytest.mark.parametrize("given", ["a tensor", "a Sharded"])
def test_eager_call_hands_each_strip_views_of_the_shards(ratio, given, monkeypatch):
    """The eager row-sharded call on ``[cpu] * 4`` gives each strip's kernel
    a ``StripSource`` whose own rows are the input's shard (the same tensor
    from a ``Sharded``, a view of the input's storage from a tensor) and
    whose neighbours are the neighbouring shards as they lie: no copy and no
    ``torch.cat`` runs outside the kernel."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from fsr_tpu_torch.kernels import easu_gather, fused

    x = _frames(3, torch.float32, (2, 3, 32, 48))
    out_hw = (64, 96) if ratio == "2x K1" else (48, 72)
    mesh = sharding.make_mesh(4, ("sp",), devices=[CPU] * 4)
    xs = Sharded.put(x, mesh, (None, None, "sp", None))
    seen, inside = [], []

    def kernel(image, out_size, *args, **kw):
        seen.append(image)
        inside.append(True)
        try:
            return torch.zeros((*image.shape[:-2], *out_size))
        finally:
            inside.pop()

    monkeypatch.setattr(fused if ratio == "2x K1" else easu_gather,
                        "upscale_fused" if ratio == "2x K1" else "easu_gather", kernel)
    ops = []

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not inside:
                ops.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    with Ops():
        out = spatial.upscale_spatial_sharded(x if given == "a tensor" else xs, out_hw, mesh, impl="kernel")
    assert len(seen) == 4 and len(out.shards) == 4
    for k, src in enumerate(seen):
        assert isinstance(src, halo.StripSource) and src.halo == (spatial._HALO if ratio == "2x K1" else spatial._GHALO)
        shard = xs.shards[k]
        if given == "a Sharded":
            assert src.own is shard
        assert src.own.shape == shard.shape and src.own.data_ptr() == shard.data_ptr()
        assert src.own.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()
        for near, j in ((src.up, k - 1), (src.down, k + 1)):
            if 0 <= j < 4:
                assert near.data_ptr() == xs.shards[j].data_ptr() and near.shape == xs.shards[j].shape
            else:
                assert near is None
    assert not [op for op in ops if op in ("cat", "copy_", "_to_copy", "clone", "contiguous")], ops


# --- the captured call's buffers against JAX's exchange ----------------------------

# strips, dtype, channels, dp x sp
JAX_CASES = ([(n, "f32", 3, False) for n in (2, 3, 4, 8)] + [(4, "u8", 4, False), (2, "bf16", 3, False)]
             + [(n, "f32", 3, True) for n in (2, 4)] + [(3, "u8", 3, True)])


def _jax_exchange(x: np.ndarray, n: int, halo_n: int, dp: bool):
    """JAX's halo exchange on the conftest's virtual CPU devices: each
    shard's ``_exchange_halo`` under ``shard_map``, as the JAX package's
    row-sharded call runs it."""
    assert len(jax.devices()) >= 8, "conftest should provide 8 CPU devices"
    mesh = jsharding.make_mesh(2 * n if dp else n, ("dp", "sp"), shape=(2, n) if dp else (1, n))
    spec = P("dp" if dp else None, None, "sp", None)
    run = shard_map(lambda b: jspatial._exchange_halo(b, lax.axis_index("sp"), "sp", n, halo_n), mesh=mesh,
                    in_specs=spec, out_specs=spec)
    return jax.jit(run)(jnp.asarray(x))


@pytest.mark.parametrize("case", JAX_CASES, ids=[f"{n} strips {d} {c}ch{' dp x sp' if dp else ''}"
                                                for n, d, c, dp in JAX_CASES])
def test_captured_buffers_equal_jax_exchange(case):
    """A ``CapturedSpatial`` call on ``[cpu] * n`` (own rows staged into its
    buffers, each strip's kernel reading its neighbours' buffers): each
    strip read by the plain strip read over the buffers bit-equal to the JAX
    shard of ``_exchange_halo``, also on the second call, from a ``Sharded``
    input."""
    n, dtype, channels, dp = case
    in_hw, out_hw = (8 * n, 24), (16 * n, 48)
    shape = (4 if dp else 2, channels, *in_hw)
    mesh = sharding.make_mesh(2 * n if dp else n, ("dp", "sp"), (2, n) if dp else (1, n), devices=[CPU] * (2 * n))
    cap = spatial.CapturedSpatial(_frames(0, DTYPES[dtype], shape), out_hw, mesh, batch_axis="dp" if dp else None,
                                  impl="kernel")
    halo_n = cap.layout.halo
    for call in range(2):
        x = _frames(1 + call, DTYPES[dtype], shape)
        cap(x if call == 0 else Sharded.put(x, mesh, cap.spec))
        want = _jax_exchange(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) if dtype == "bf16" else x.numpy(),
                             n, halo_n, dp)
        rows = in_hw[0] // n + 2 * halo_n
        shards = {(s.index[0].start or 0, s.index[2].start or 0): np.asarray(s.data) for s in want.addressable_shards}
        bufs = cap.buffers
        assert all(tuple(b.shape) == (shape[0] // 2 if dp else shape[0], channels, in_hw[0] // n, in_hw[1])
                   for b in bufs)
        for j in range(len(bufs)):
            g, k = divmod(j, n)
            buf = halo.halo_rows_reference(halo.StripSource(bufs[j - 1] if k else None, bufs[j],
                                                            bufs[j + 1] if k + 1 < n else None, halo_n))
            w = shards[(g * shape[0] // 2 if dp else 0, k * rows)]
            got = buf.float().numpy() if dtype == "bf16" else buf.numpy()
            assert w.dtype == (np.dtype(jnp.bfloat16) if dtype == "bf16" else got.dtype)
            np.testing.assert_array_equal(got, w.astype(got.dtype), err_msg=f"call {call}, strip {j}")


# --- the event schedule ------------------------------------------------------------


def _violations(order, reads, calls):
    """Run the host's steps of a queue of calls (``calls``: one list of
    steps each) on a model of one stream per device (a wait binds to its
    event's latest record, as ``cudaStreamWaitEvent`` does) and return the
    broken orders.  ``("write", e)`` writes e's own-row buffer (``put``'s
    copy, a producer's write, a call's copy of another input); ``("stage",
    d)`` writes d's own statics (frame, grain rows, page), which only d's
    program reads.  Broken: a replay reading a buffer before that call's
    write of it, or a write that may land before a replay of the call
    before has read what it overwrites."""
    edges, last, events, node = {}, {}, {}, itertools.count()
    writes, stage, replay = {}, {}, {}

    def add(dev, after=()):
        v = next(node)
        edges[v] = set(after) | ({last[dev]} if dev in last else set())
        last[dev] = v
        return v

    for c, steps in enumerate(calls):
        for step in steps:
            kind, dev = step[:2]
            if kind == "wait":
                add(dev, [events[step[2]]] if step[2] in events else [])
            elif kind == "record":
                events[step[2]] = add(dev)
            else:
                {"write": writes, "stage": stage, "replay": replay}[kind][(dev, c)] = add(dev)

    def before(a, b):  # a happens before b
        seen, todo = set(), [b]
        while todo:
            v = todo.pop()
            if v == a:
                return True
            if v not in seen:
                seen.add(v)
                todo.extend(edges[v])
        return False

    bad = []
    for c in range(len(calls)):
        for d in order:
            for e, w in [(e, writes.get((e, c))) for e in (d, *reads[d])] + [(d, stage[(d, c)])]:
                if w is None:
                    continue
                if not before(w, replay[(d, c)]):
                    bad.append(f"call {c}: {d}'s replay may read {e} before its write")
                if c and not before(replay[(d, c - 1)], w):
                    bad.append(f"call {c}: the write on {e} may overwrite what {d}'s replay of call {c - 1} reads")
    return bad


def _put_call(write, stage, replay, devices):
    """``put`` then a call from ``inputs`` (or a call from any other input,
    which ``put``s it): every buffer written after the write steps."""
    return write + [("write", e) for e in devices] + stage + replay


def _queues(order, reads):
    """Three queued calls each way: ``put`` + call; ``writable()`` + a
    producer's writes (in reverse order, then only every other device's) +
    call; and a mix of the two with a call that writes nothing."""
    write, stage, replay = spatial._schedule(order, reads)
    produce = [write + [("write", e) for e in order[::-1]] + stage + replay,
               write + [("write", e) for e in order[1::2]] + stage + replay,
               write + [("write", e) for e in order] + stage + replay]
    return {"put + call": [_put_call(write, stage, replay, order)] * 3,
            "writable() + write + call": produce,
            "mixed": [_put_call(write, stage, replay, order), stage + replay, produce[0]]}


@pytest.mark.parametrize("cards,n", [(2, 2), (3, 3), (4, 4), (4, 2)], ids=["2 cards", "3 cards", "4 cards",
                                                                           "dp x sp on 4 cards"])
def test_event_schedule_orders_three_queued_calls(cards, n):
    devices = [torch.device("cuda", i) for i in range(cards)]
    order, reads = spatial._reads(devices, n)
    assert order == devices
    write, stage, replay = spatial._schedule(order, reads)
    # The write steps are waits only; a device's stage and replay come once
    # each per call; every record names an event of the device it runs on.
    assert {s[0] for s in write} == {"wait"} and all(s[2][0] == "done" for s in write)
    assert [s[1] for s in stage if s[0] == "stage"] == devices == [s[1] for s in replay if s[0] == "replay"]
    assert all(s[2][1] == s[1] for s in stage + replay if s[0] == "record")
    for what, queue in _queues(order, reads).items():
        assert _violations(order, reads, queue) == [], what
        # Without either kind of wait the model finds the hazard.
        for kind in ("staged", "done"):
            cut = [[s for s in steps if not (s[0] == "wait" and s[2][0] == kind)] for steps in queue]
            assert _violations(order, reads, cut), f"{what}: a schedule without its {kind!r} waits passed"


def test_reads_are_the_neighbours_and_the_frame():
    """Each card's program reads its strips' neighbours' buffers, and the
    frame from its own static: no card reads the first card for the frame."""
    c = [torch.device("cuda", i) for i in range(4)]
    order, reads = spatial._reads(c, 4)
    assert reads == {c[0]: (c[1],), c[1]: (c[0], c[2]), c[2]: (c[1], c[3]), c[3]: (c[2],)}
    write, stage, replay = spatial._schedule(order, reads)
    assert sum(s[0] == "wait" for s in write + stage + replay) == 12  # 6 "done", 6 "staged"
    _, reads = spatial._reads(c, 2)  # dp x sp: (c0, c1) and (c2, c3)
    assert reads == {c[0]: (c[1],), c[1]: (c[0],), c[2]: (c[3],), c[3]: (c[2],)}
    order, reads = spatial._reads([c[0]] * 4, 4)  # one card: its stream orders everything
    assert order == [c[0]] and reads == {c[0]: ()}
    assert spatial._schedule(order, reads) == ([], [("stage", c[0])], [("replay", c[0])])


# --- peer access -------------------------------------------------------------------


def test_cards_without_peer_access_raise(monkeypatch):
    """Construction checks every pair of cards whose programs read each
    other before it allocates anything, and names the pair without access."""
    monkeypatch.setattr(halo, "can_access_peer", lambda a, b: (a.index, b.index) != (2, 1))
    mesh = sharding.make_mesh(4, ("sp",), devices=[torch.device("cuda", i) for i in range(4)])
    x = torch.zeros((2, 3, 32, 48))
    with pytest.raises(ValueError, match=r"cuda:2 cannot read cuda:1's memory \(no peer access\)"):
        spatial.CapturedSpatial(x, (64, 96), mesh)


def test_enable_peers_enables_each_pair_once(monkeypatch):
    calls = []

    class Lib:
        @staticmethod
        def fsr_enable_peer(a, b):
            calls.append((a, b))
            return 0

    from fsr_tpu_torch.kernels import _build

    monkeypatch.setattr(halo, "can_access_peer", lambda a, b: True)
    monkeypatch.setattr(_build, "library", lambda: Lib)
    c = [torch.device("cuda", i) for i in range(4)]
    _, reads = spatial._reads(c, 4)
    halo.enable_peers([(d, e) for d, r in reads.items() for e in r] + [(c[1], c[0]), (c[0], c[0])])
    assert sorted(calls) == [(0, 1), (1, 0), (1, 2), (2, 1), (2, 3), (3, 2)]
    calls.clear()
    halo.enable_peers([(c[0], c[0]), (CPU, CPU)])  # one device, or the CPU: nothing to enable
    assert calls == []
