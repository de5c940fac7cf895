"""lbm_tpu_torch.io.avi and io.video on the CPU, against lbm_tpu.io.video.

The port's AVI writer round trip (the cases of tests/test_io.py:50-76)
and read_frames; the port's VideoRecorder against JAX's VideoRecorder on
the same f64 macros (LBM_VIDEO_FORMAT=avi: the tiles and strips equal);
the strips without PIL; the writer's order and its error when nothing
opens; the probe plots; the CLIs' frames (the plasma's pre-step macros,
one frame a window under --multistep; the cavity's chunks and frames);
the sharded plasma and cavity videos of two gloo ranks equal the
single-device ones bit for bit. The golden 200-frame hold against
artifacts/golden_200/video is the slow test at the end.
"""
import os
import struct
import sys
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.io import avi as javi
from lbm_tpu.io import video as jvideo
from lbm_tpu_torch import run_cavity, run_plasma
from lbm_tpu_torch.config import PlasmaConfig
from lbm_tpu_torch.io import avi, colormap, probes, video
from lbm_tpu_torch.models import plasma

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_ranks as ranks  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_avi_writer_roundtrip(tmp_path):
    """tests/test_io.py::test_avi_writer_roundtrip on the port's writer,
    and read_frames of it."""
    path = str(tmp_path / "test.avi")
    w, h, n = 33, 20, 5          # a row of 99 bytes: 1 byte of padding
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255, size=(n, h, w, 3), dtype=np.uint8)
    with avi.AviWriter(path, w, h, fps=2) as vw:
        for fr in frames:
            vw.write(fr)
    data = open(path, "rb").read()
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI "
    assert struct.unpack("<I", data[4:8])[0] == len(data) - 8
    assert data.count(b"00db") == 2 * n  # movi chunks + idx1 entries
    movi = data.index(b"movi")
    first = data.index(b"00db", movi)
    size = struct.unpack("<I", data[first + 4:first + 8])[0]
    payload = np.frombuffer(data[first + 8:first + 8 + size], np.uint8)
    row = w * 3
    got = payload.reshape(h, (row + 3) & ~3)[:, :row].reshape(h, w, 3)
    np.testing.assert_array_equal(got, frames[0][::-1, :, ::-1])
    np.testing.assert_array_equal(avi.read_frames(path), frames)
    with pytest.raises(ValueError, match="want"):
        avi.AviWriter(str(tmp_path / "b.avi"), w, h).write(frames[0][:-1])


def test_read_frames_reads_the_jax_writers_files(tmp_path):
    if not javi.available():
        pytest.skip("the JAX package's native writer does not build here")
    path = str(tmp_path / "jax.avi")
    frames = np.random.default_rng(1).integers(0, 255, (3, 7, 10, 3),
                                               dtype=np.uint8)
    with javi.AviWriter(path, 10, 7, fps=1) as vw:
        for fr in frames:
            vw.write(fr)
    np.testing.assert_array_equal(avi.read_frames(path), frames)
    # the port's writer builds beside the CUDA kernels, not in native/
    lib = avi.build()
    assert lib.exists() and "build/torch_kernels/aviwriter" in str(lib)


def _macros(rng, NY, NX):
    """Random f64 macros over each field's range: (JAX's, the port's)."""
    def field(name):
        lo, hi = colormap.RANGES[name]
        w = hi - lo
        return lo - 0.05 * w + 1.1 * w * rng.random((NY, NX))
    rho = np.stack([field("rho_e"), field("rho_i"), field("rho_e")])
    ux = np.stack([field("ux_e"), field("ux_i"), field("ux_i")])
    uy = np.stack([field("uy_e"), field("uy_i"), field("uy_i")])
    T = np.stack([field("T_e"), field("T_i"), field("T_n")])
    rho_q = field("rho_q")
    return (SimpleNamespace(rho=jnp.asarray(rho), ux=jnp.asarray(ux),
                            uy=jnp.asarray(uy), T=jnp.asarray(T),
                            rho_q=jnp.asarray(rho_q)),
            SimpleNamespace(**{k: torch.from_numpy(v) for k, v in dict(
                rho=rho, ux=ux, uy=uy, T=T, rho_q=rho_q).items()}))


def test_recorder_equals_jax_recorder(tmp_path, monkeypatch):
    """Three frames of the same f64 macros through both recorders, both
    writing native AVIs: every frame equal, label strips included (both
    draw them with PIL here); the port's frames are 30-px strips over
    each row of tiles."""
    monkeypatch.setenv("LBM_VIDEO_FORMAT", "avi")
    if not javi.available():
        pytest.skip("the JAX package's native writer does not build here")
    NY, NX = 12, 16
    rng = np.random.default_rng(2)
    jrec = jvideo.VideoRecorder(str(tmp_path / "jax"), NX, NY)
    trec = video.VideoRecorder(str(tmp_path / "port"), NX, NY)
    for _ in range(3):
        jm, tm = _macros(rng, NY, NX)
        jrec.record(jm)
        trec.record(tm)
    jrec.close()
    trec.close()
    for kind, path in trec.paths.items():
        assert path.endswith(f"video_{kind}.avi")
        got = avi.read_frames(path)
        want = avi.read_frames(jrec.paths[kind])
        rows = 2 if kind == "velocity" else 1
        assert got.shape == (3, rows * (NY + 30), 3 * NX, 3), kind
        np.testing.assert_array_equal(got, want, err_msg=kind)


def test_strips_without_pil(tmp_path, monkeypatch, capsys):
    """Without PIL a strip keeps its size and colorbars; its text rows are
    the background. The recorder says so once."""
    labels = ["ux_e", "uy_e", "|u_e|"]
    with_pil = video._label_strip(labels, 96)
    monkeypatch.setitem(sys.modules, "PIL", None)
    bare = video._label_strip(labels, 96)
    assert bare.shape == with_pil.shape == (30, 96, 3)
    np.testing.assert_array_equal(bare[24:], with_pil[24:])
    assert (bare[:24] == 32).all() and not (with_pil[:24] == 32).all()
    monkeypatch.setenv("LBM_VIDEO_FORMAT", "avi")
    rec = video.VideoRecorder(str(tmp_path), 32, 8)
    rec.close()
    assert capsys.readouterr().out.count("PIL is absent") == 1


def test_writer_order_and_missing_backends(tmp_path, monkeypatch, capsys):
    """mp4v where cv2 opens, else the native AVI, else GIF; with none, an
    error that names each; LBM_VIDEO_FORMAT skips backends."""
    p = str(tmp_path / "v.avi")
    w = video.open_writer(p, 8, 6, 1)
    assert w.path.endswith(".mp4") and "mp4v" in capsys.readouterr().out
    w.close()
    monkeypatch.setenv("LBM_VIDEO_FORMAT", "gif")
    w = video.open_writer(p, 8, 6, 1)
    assert w.path.endswith(".gif")
    w.write(np.zeros((6, 8, 3), np.uint8))
    w.close()
    assert os.path.exists(w.path)
    monkeypatch.delenv("LBM_VIDEO_FORMAT")
    monkeypatch.setitem(sys.modules, "cv2", None)
    w = video.open_writer(p, 8, 6, 1)
    assert w.path == p and "native AVI" in capsys.readouterr().out
    w.close()

    def broken():
        raise avi.AviBuildError("g++ refused it")
    monkeypatch.setattr(avi, "load", broken)
    w = video.open_writer(p, 8, 6, 1)
    assert w.path.endswith(".gif")
    assert "g++ refused it" in capsys.readouterr().out
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError) as e:
        video.open_writer(p, 8, 6, 1)
    for what in ("mp4v", "g++ refused it", "GIF"):
        assert what in str(e.value)


def test_frame_queue_writes_in_order_and_raises_on_close():
    """FrameQueue hands frame i of each set to writer i, in order, and a
    writer's error comes out of close(), after every writer closed."""
    class Sink:
        def __init__(self, fail_at=None):
            self.frames, self.closed, self.fail_at = [], False, fail_at
            self.path = "sink"

        def write(self, frame):
            if len(self.frames) == self.fail_at:
                raise OSError("disk full")
            self.frames.append(frame.copy())

        def close(self):
            self.closed = True

    a, b = Sink(), Sink()
    q = video.FrameQueue([a, b])
    sets = [[torch.full((2, 3, 3), 2 * i, dtype=torch.uint8),
             torch.full((4, 3, 3), 2 * i + 1, dtype=torch.uint8)]
            for i in range(20)]
    for frames in sets:
        q.put(frames)
    q.close()
    assert a.closed and b.closed and q.paths == ["sink", "sink"]
    for sink, k in ((a, 0), (b, 1)):
        assert len(sink.frames) == 20
        for got, frames in zip(sink.frames, sets):
            np.testing.assert_array_equal(got, frames[k].numpy())
    bad, ok = Sink(fail_at=3), Sink()
    q = video.FrameQueue([bad, ok])
    for frames in sets:
        q.put(frames)
    with pytest.raises(OSError, match="disk full"):
        q.close()
    assert bad.closed and ok.closed


def test_save_plots(tmp_path, monkeypatch, capsys):
    rec = probes.ProbeRecorder(16, 16, "cpu")
    cfg = PlasmaConfig(NX=16, NY=16, dtype=torch.float64)
    s = plasma.init_state(cfg, "cpu")
    for _ in range(2):
        rec.record(plasma.compute_macros(cfg, s), s.Ex, s.Ey)
    rec.save_plots(str(tmp_path / "a"))
    names = sorted(os.listdir(tmp_path / "a"))
    assert names == sorted(f"plot_{q}.png" for q in probes.QUANTITIES)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    rec.save_plots(str(tmp_path / "b"))
    assert "skipped" in capsys.readouterr().out
    assert not os.path.exists(tmp_path / "b")


def test_plasma_cli_frames_are_the_pre_step_macros(tmp_path, monkeypatch):
    """The first frame renders the initial state's macros; under
    --multistep 2 --video-every 4 a frame is taken at the window starts
    t = 0 and 4 of 8 steps."""
    monkeypatch.setenv("LBM_VIDEO_FORMAT", "avi")
    base = ["--device", "cpu", "--nx", "16", "--ny", "12", "--f64",
            "--no-plots"]
    s = run_plasma.main(base + ["--steps", "2", "--out",
                                str(tmp_path / "a")])
    cfg = PlasmaConfig(NX=16, NY=12, dtype=torch.float64,
                       neutral_delta=False)
    want = colormap.render_all(*colormap.macro_fields(plasma.compute_macros(
        cfg, plasma.init_state(cfg, "cpu"))))
    for (kind, path), frame in zip(sorted(s["video"].items()),
                                   (want[0], want[2], want[1])):
        got = avi.read_frames(path)
        rows = 2 if kind == "velocity" else 1
        assert got.shape[0] == 2, kind
        tiles = np.concatenate([got[0, r * 42 + 30:(r + 1) * 42]
                                for r in range(rows)])
        np.testing.assert_array_equal(
            tiles, colormap.JET_PALETTE[frame.numpy()], err_msg=kind)
    s = run_plasma.main(base + ["--steps", "8", "--multistep", "2",
                                "--video-every", "4", "--out",
                                str(tmp_path / "b")])
    assert avi.read_frames(s["video"]["density"]).shape[0] == 2
    s = run_plasma.main(base + ["--steps", "2", "--no-video", "--out",
                                str(tmp_path / "c")])
    assert s["video"] is None and not os.path.exists(tmp_path / "c" /
                                                     "video")


def test_plasma3d_cli_writes_png_slices(tmp_path):
    """--slice-every writes slice_<step>.npz and, with matplotlib, the JAX
    CLI's figure as slice_<step>.png."""
    from lbm_tpu_torch import run_plasma3d

    run_plasma3d.main(["--device", "cpu", "--n", "8", "--nz", "4",
                       "--steps", "2", "--slice-every", "2", "--out",
                       str(tmp_path)])
    assert os.path.getsize(tmp_path / "slice_00002.png") > 0
    with np.load(tmp_path / "slice_00002.npz") as z:
        assert z["rho_e"].shape == z["rho_q"].shape == (8, 8)


def test_cavity_chunks():
    """Chunks end at every multiple of each cadence; one cadence (no
    video) gives the checkpoint chunks of before, none the whole run."""
    assert run_cavity.chunk_lengths(250, [100]) == [100, 100, 50]
    assert run_cavity.chunk_lengths(100, [40, 30]) == [30, 10, 20, 20, 10,
                                                        10]
    assert run_cavity.chunk_lengths(7, []) == [7]
    assert run_cavity.chunk_lengths(0, [5]) == []


def test_cavity_cli_frames(tmp_path, monkeypatch):
    """--video-every 20 over 60 steps: 3 frames, the last one the frame of
    the final state; with --checkpoint-every 30 the chunks end at 20, 30,
    40 and 60 and the state is the same."""
    monkeypatch.setenv("LBM_VIDEO_FORMAT", "avi")
    base = ["--device", "cpu", "--nx", "20", "--steps", "60",
            "--video-every", "20"]
    s = run_cavity.main(base + ["--out", str(tmp_path / "a")])
    frames = avi.read_frames(s["video"])
    assert frames.shape == (3, 20, 20, 3)
    np.testing.assert_array_equal(
        frames[-1], colormap.cavity_frame(s["state"].ux,
                                          s["state"].uy).numpy())
    c = run_cavity.main(base + ["--checkpoint-every", "30", "--out",
                                str(tmp_path / "b")])
    assert torch.equal(c["state"].f, s["state"].f)
    np.testing.assert_array_equal(avi.read_frames(c["video"]), frames)


def test_sharded_videos_equal_single_device(tmp_path):
    """Two gloo ranks: the plasma's tiles gathered by rank 0 and the
    cavity's frames under the global min and max equal the single-device
    CLIs' frames bit for bit."""
    procs = ranks.Ranks("video", 2, tmp_path)
    os.environ["LBM_VIDEO_FORMAT"] = "avi"
    try:
        plasma_one = run_plasma.main([*ranks.VIDEO_PLASMA, "--out",
                                      str(tmp_path / "one")])
        cavity_one = run_cavity.main([*ranks.VIDEO_CAVITY, "--out",
                                      str(tmp_path / "one_cavity")])
    finally:
        del os.environ["LBM_VIDEO_FORMAT"]
    out = procs.result()       # the ranks ran meanwhile
    assert out["mesh"] == {"dy": 2, "dx": 1}
    for kind, path in plasma_one["video"].items():
        want = avi.read_frames(path)
        assert want.shape[0] == 3
        np.testing.assert_array_equal(out["plasma"][kind], want,
                                      err_msg=kind)
    want = avi.read_frames(cavity_one["video"])
    assert want.shape == (3, 32, 32, 3) and len(np.unique(want)) > 8
    np.testing.assert_array_equal(out["cavity"], want)


@pytest.mark.slow
def test_golden_videos_meet_the_f32_gates(tmp_path):
    """Hold 2: the port's golden run on the CPU against
    artifacts/golden_200/video at compare_golden_videos.GATES["f32"]."""
    pytest.importorskip("cv2")
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import compare_golden_videos_torch as cmp

    rc = cmp.main(["--device", "cpu", "--json", str(tmp_path / "v.json")])
    assert rc == 0
