"""Interactive terminal viewer: the reference's window and event loop
(src/main.c:520-574, src/gpu_and_windowing.c) on a headless host.

Counterpart of ``ray_tracing_tpu/apps/viewer.py``. Frames render on the
device with progressive refinement (render/film.py) and are painted into
the terminal as ANSI 24-bit half-block cells; input is the raw-mode
keyboard (WASD move, arrows/IJKL look, SPACE screenshot, Q/ESC quit) and
terminal mouse reports (mouse look).

The event model is the reference's: the queued events are drained before
each pass (pop_event, src/gpu_and_windowing.c:231-246), and any camera
event invalidates the accumulation: a fresh Film and the pyramid again
from init_scale (invalidate_accumulation, src/main.c:115-124, and the
workers' scale reset, src/main.c:405-408).
"""

from __future__ import annotations

import ctypes
import os
import select
import sys
import time

import numpy as np

from ray_tracing_tpu_torch.config import RenderConfig
from ray_tracing_tpu_torch.io.image import screenshot
from ray_tracing_tpu_torch.render import camera as cam_mod
from ray_tracing_tpu_torch.render.film import Film, lowres_size, pass_seed, progressive_scales
from ray_tracing_tpu_torch.utils.profiling import RateMeter, rays_per_frame

# Event ids (after src/gpu_and_windowing.h:18-33)
EV_QUIT, EV_W, EV_A, EV_S, EV_D, EV_LOOK, EV_SHOT, EV_MOUSE = range(8)

_LOOK_KEYS = {
    "i": (0, 60.0), "k": (0, -60.0), "j": (-60.0, 0), "l": (60.0, 0),
    "\x1b[A": (0, 60.0), "\x1b[B": (0, -60.0), "\x1b[D": (-60.0, 0), "\x1b[C": (60.0, 0),
}


class TerminalInput:
    """The Python event source: keyboard and mouse bytes read from a
    terminal's file descriptor and parsed into viewer events.

    Escape sequences can split across reads (arrow-key autorepeat streams
    3-byte sequences through fixed-size reads), so a trailing partial
    "\\x1b" / "\\x1b[" waits for the next poll instead of being read as a
    bare ESC (= quit); a lone ESC that nothing follows for two polls is the
    ESC key."""

    def __init__(self, fd: int):
        self.fd = fd
        self._pending = ""     # a partial escape sequence carried over
        self._pending_age = 0  # polls a lone ESC has waited

    def poll(self, timeout: float = 0.0) -> list:
        """Drain the pending input into a list of events, waiting at most
        `timeout` seconds for the first byte."""
        events = []
        buf = self._pending
        self._pending = ""
        got_new = False
        while select.select([self.fd], [], [], timeout)[0]:
            timeout = 0.0
            # latin-1: one byte, one character. X10 mouse payloads carry raw
            # bytes >= 0x80 for coordinates over 95, which utf-8 would drop.
            ch = os.read(self.fd, 64).decode("latin-1")
            if not ch:
                break
            buf += ch
            got_new = True
        if buf == "\x1b" and not got_new:
            self._pending_age += 1
            if self._pending_age >= 2:
                self._pending_age = 0
                return [(EV_QUIT, None)]
            self._pending = buf
            return events
        self._pending_age = 0
        ch = buf
        i = 0
        while i < len(ch):
            c = ch[i]
            if c == "\x1b":
                nxt = ch[i + 1] if i + 1 < len(ch) else ""
                if nxt == "":
                    self._pending = ch[i:]  # lone ESC at the end: wait, age
                    break
                if nxt == "[":
                    # CSI: parameters and intermediates, one final byte @..~
                    j = i + 2
                    while j < len(ch) and not ("@" <= ch[j] <= "~"):
                        j += 1
                    if j >= len(ch):
                        self._pending = ch[i:]  # incomplete CSI: wait
                        break
                    seq = ch[i:j + 1]
                    if seq == "\x1b[M":
                        # X10 mouse report: ESC [ M + 3 raw payload bytes
                        # (button+32, x+32, y+32). The payload is printable
                        # and must not reach the key switch below.
                        if j + 4 > len(ch):
                            self._pending = ch[i:]  # payload split across reads
                            break
                        b, x, y = (ord(t) - 32 for t in ch[j + 1:j + 4])
                        if b & 32:  # motion
                            events.append((EV_MOUSE, (float(x), float(y))))
                        i = j + 4
                        continue
                    if seq in _LOOK_KEYS:
                        events.append((EV_LOOK, _LOOK_KEYS[seq]))
                    elif seq.startswith("\x1b[<") and seq[-1] in "Mm":
                        # SGR-1006 mouse report "<b;x;y[Mm]": mouse look (the
                        # reference's MOVE_MOUSE, src/gpu_and_windowing.c:266-269)
                        try:
                            b, x, y = (int(t) for t in seq[3:-1].split(";"))
                            if b & 32:  # motion
                                events.append((EV_MOUSE, (float(x), float(y))))
                        except ValueError:
                            pass
                    i = j + 1  # any other CSI (modifiers, F5+): swallowed
                    continue
                if nxt == "O":
                    i += 3  # SS3 (F1-F4): the 3-byte sequence is swallowed
                    continue
                events.append((EV_QUIT, None))  # ESC then a plain key: the ESC key
                i += 1
                continue
            lc = c.lower()
            if lc == "q":
                events.append((EV_QUIT, None))
            elif lc == "w":
                events.append((EV_W, None))
            elif lc == "a":
                events.append((EV_A, None))
            elif lc == "s":
                events.append((EV_S, None))
            elif lc == "d":
                events.append((EV_D, None))
            elif lc in _LOOK_KEYS:
                events.append((EV_LOOK, _LOOK_KEYS[lc]))
            elif c == " ":
                events.append((EV_SHOT, None))
            i += 1
        return events

    def stop(self) -> None:
        pass


_BYTE_STRS = [str(v) for v in range(256)]


def frame_to_ansi(img: np.ndarray) -> str:
    """(H, W, 3) float frame -> ANSI 24-bit half-block string, two pixel rows
    per cell (an odd last row is dropped). The cells are assembled from
    precomputed byte strings: per-cell f-strings dominated the frame time
    at viewer sizes."""
    h = img.shape[0] - (img.shape[0] % 2)
    u8 = np.clip(img[:h] * 255.0, 0, 255).astype(np.uint8)
    top, bot = u8[0::2], u8[1::2]
    rows, cols = top.shape[0], top.shape[1]
    t = top.reshape(rows * cols, 3)
    b = bot.reshape(rows * cols, 3)
    s = _BYTE_STRS
    cells = [
        "\x1b[38;2;" + s[tr] + ";" + s[tg] + ";" + s[tb]
        + "m\x1b[48;2;" + s[br] + ";" + s[bg] + ";" + s[bb] + "m▀"
        for (tr, tg, tb), (br, bg, bb) in zip(t.tolist(), b.tolist())
    ]
    lines = ["".join(cells[r * cols:(r + 1) * cols]) + "\x1b[0m" for r in range(rows)]
    return "\n".join(lines)


class Viewer:
    """The progressive interactive loop.

    render_fn(scene, camera, film, seed, scale) -> (film, spp) renders one
    pass (apps/cli.py::make_cuda_render_fn): spp is what the pass took,
    which the rays/s count uses. The film lies on the scene's device."""

    def __init__(self, scene, camera, width, height, config: RenderConfig, render_fn,
                 resolve_fn=None, out=sys.stdout):
        self.scene = scene
        self.camera = camera
        self.width = width
        self.height = height
        self.config = config
        self.render_fn = render_fn
        self.resolve_fn = resolve_fn or (lambda film: film.resolve().cpu().numpy())
        self.out = out
        self.film = Film.zero(width, height, device=scene.device)
        self.scales = progressive_scales(config)
        self.pass_i = 0
        self.frame_count = 0
        self.meter = RateMeter()
        self._cell_px = None
        self._mouse_last = None

    def invalidate(self):
        """invalidate_accumulation (src/main.c:115-124): a fresh film and the
        pyramid again."""
        self.film = Film.zero(self.width, self.height, device=self.scene.device)
        self.pass_i = 0

    def resize(self, width: int, height: int):
        """realloc_frame_buffer (src/main.c:416-448): buffers of the new
        size, the accumulation restarted."""
        if (width, height) == (self.width, self.height):
            return
        self.width, self.height = width, height
        self._cell_px = None  # the terminal's metrics may have changed
        self.invalidate()

    def fit_terminal(self, max_w: int = 192, max_h: int = 108) -> None:
        """Match the render size to the terminal: two pixel rows per cell,
        one line kept for the HUD."""
        try:
            size = os.get_terminal_size(self.out.fileno())
        except (OSError, ValueError):
            return
        w = max(16, min(size.columns, max_w))
        h = max(8, min((size.lines - 2) * 2, max_h))
        self.resize(w, h - h % 2)

    def _cell_pixels(self):
        """Screen pixels per terminal cell: TIOCGWINSZ's ws_xpixel and
        ws_ypixel where the terminal reports them, a typical 10 x 20
        otherwise. Probed again after a resize."""
        if self._cell_px is not None:
            return self._cell_px
        cw, ch = 10.0, 20.0
        try:
            import fcntl
            import struct
            import termios

            ws = fcntl.ioctl(self.out.fileno(), termios.TIOCGWINSZ, b"\x00" * 8)
            rows, cols, xpx, ypx = struct.unpack("HHHH", ws)
            if cols > 0 and xpx > 0:
                cw = xpx / cols
            if rows > 0 and ypx > 0:
                ch = ypx / rows
        except (OSError, ValueError, AttributeError):
            pass  # not a terminal: the typical cell
        self._cell_px = (cw, ch)
        return self._cell_px

    def handle_events(self, events) -> bool:
        """Apply the events in order; False when the loop should end."""
        speed = self.config.move_speed
        moves = {EV_W: cam_mod.UP, EV_S: cam_mod.DOWN, EV_A: cam_mod.LEFT,
                 EV_D: cam_mod.RIGHT}
        for ev, arg in events:
            if ev == EV_QUIT:
                return False
            if ev in moves:
                self.camera = cam_mod.move(self.camera, moves[ev], speed, self.config)
                self.invalidate()
            elif ev == EV_LOOK:
                dx, dy = arg
                self.camera = cam_mod.rotate(self.camera, dx, dy, self.config)
                self.invalidate()
            elif ev == EV_MOUSE:
                # mouse look from absolute positions, with the reference's
                # first-move skip and y inversion (src/camera.c:44-56:
                # x - last_x, last_y - y)
                x, y = arg
                last = self._mouse_last
                self._mouse_last = (x, y)
                if last is not None:
                    dx, dy = x - last[0], last[1] - y
                    if dx or dy:
                        # the reports count terminal CELLS, rotate() wants
                        # window pixels at 0.1 degree each (src/camera.c:42-78)
                        cw, ch = self._cell_pixels()
                        self.camera = cam_mod.rotate(self.camera, dx * cw, dy * ch,
                                                     self.config)
                        self.invalidate()
            elif ev == EV_SHOT:
                path = screenshot(self.resolve_fn(self.film))
                print(f"\nTook screenshot! ({path})", file=sys.stderr)
        return True

    def step(self, seed: int) -> int:
        """One refinement pass at the current pyramid scale, seeded `seed`;
        returns the scale."""
        scale = self.scales[min(self.pass_i, len(self.scales) - 1)]
        self.film, spp = self.render_fn(self.scene, self.camera, self.film, seed, scale)
        # each pass at the samples it really took (the JAX viewer counts
        # every pass as one sample, which reads 4x low at full res)
        lw, lh = lowres_size(self.width, self.height, scale)
        self.meter.add(rays_per_frame(lw, lh, spp, self.config))
        self.pass_i += 1
        self.frame_count += 1
        return scale

    def draw(self):
        img = self.resolve_fn(self.film)
        hud = ""
        if self.frame_count:
            hud = (f"\x1b[0m\n pass {self.pass_i}  weight {float(self.film.weight):.2f}"
                   f"  {self.meter.format()}  [WASD move  IJKL look  SPACE shot  Q quit]\x1b[K")
        # row 0 is the bottom of the scene: the reference's GL quad shows it
        # at the bottom (assets/screen.vs) and save_png flips on write, so
        # flip here to match both
        self.out.write("\x1b[H" + frame_to_ansi(img[::-1]) + hud)
        self.out.flush()


# Native event ids (native/rt_native.cpp) -> viewer events
_NATIVE_MAP = {
    1: (EV_QUIT, None), 3: (EV_QUIT, None),               # CLOSE / ESC
    4: (EV_W, None), 5: (EV_A, None), 6: (EV_S, None), 7: (EV_D, None),
    2: (EV_SHOT, None),
    20: (EV_LOOK, (0, 60.0)), 21: (EV_LOOK, (0, -60.0)),
    22: (EV_LOOK, (-60.0, 0)), 23: (EV_LOOK, (60.0, 0)),
}


class NativeEventSource:
    """The C++ ring-buffer event queue fed by a reader thread
    (native/rt_native.cpp, after src/gpu_and_windowing.c:220-269)."""

    def __init__(self, lib, fd):
        self.lib = lib
        if lib.rt_events_start(fd) != 0:
            raise RuntimeError("event reader already running")

    def poll(self, timeout: float = 0.0) -> list:
        events = []
        while True:
            ev = self.lib.rt_events_pop()
            if ev == 0:
                return events
            if ev == 8:  # EVENT_MOVE_MOUSE: the coordinates are fetched after it
                x, y = ctypes.c_double(), ctypes.c_double()
                self.lib.rt_mouse_pos(ctypes.byref(x), ctypes.byref(y))
                events.append((EV_MOUSE, (x.value, y.value)))
                continue
            mapped = _NATIVE_MAP.get(ev)
            if mapped is not None:
                events.append(mapped)

    def stop(self) -> None:
        self.lib.rt_events_stop()


def run_interactive(viewer: Viewer, max_frames=None, use_native: bool = True,
                    auto_resize: bool = False):
    """The raw-terminal main loop (the reference's, src/main.c:520-574).

    Input comes from the C++ event queue where the native library loads
    (use_native), else from TerminalInput. Pass n of the session is seeded
    render/film.py::pass_seed(seed, n), seed the clock's seconds at the
    start and n counting every pass drawn, so no two passes share a
    sample."""
    import termios
    import tty

    from ray_tracing_tpu_torch import native

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    base = int(time.time())

    source = None
    if use_native:
        lib = native.lib()
        if lib is not None:
            try:
                source = NativeEventSource(lib, fd)
            except RuntimeError:
                source = None
    if source is None:
        source = TerminalInput(fd)
    try:
        tty.setcbreak(fd)
        # any-motion mouse tracking in SGR-1006 encoding: mouse look as the
        # reference's GLFW cursor callback gives it
        viewer.out.write("\x1b[?1003h\x1b[?1006h")
        viewer.out.write("\x1b[2J")  # clear
        running = True
        while running and (max_frames is None or viewer.frame_count < max_frames):
            if auto_resize:
                viewer.fit_terminal()
            running = viewer.handle_events(source.poll())
            viewer.step(pass_seed(base, viewer.frame_count))
            viewer.draw()
    finally:
        source.stop()
        termios.tcsetattr(fd, termios.TCSADRAIN, old)
        viewer.out.write("\x1b[?1003l\x1b[?1006l\x1b[0m\n")
