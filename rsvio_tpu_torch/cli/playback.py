"""Interactive playback control: step mode with auto-play toggle.

Port of rsvio_tpu/cli/playback.py (the reference's FrameContext playback
state, ref src/datasets/mod.rs:30-50: `step_mode`, `auto_play`,
`advance_frame`), a non-blocking single-key controller:

    <enter>/<space>  advance one frame          (ref advance_frame)
    a                toggle auto-play           (ref auto_play)
    q                quit playback

The key source is injected so the state machine is unit-testable without a
TTY; the default source polls stdin via select() (no thread, no blocking
read when auto-playing).
"""

from __future__ import annotations

import sys


EOF_KEY = "<eof>"


def _poll_stdin(timeout: float):
    """One key (line-buffered) from stdin within `timeout` seconds, or None.

    Uses select() so auto-play never blocks. Works line-buffered (the user
    presses enter); raw tcsetattr modes are deliberately avoided to keep the
    terminal state crash-safe. Returns EOF_KEY when stdin is exhausted/closed
    (select reports such an fd as permanently ready — treating that as "no
    key" would spin a 100%-CPU busy loop in stepping mode).
    """
    import select

    try:
        ready, _, _ = select.select([sys.stdin], [], [], timeout)
    except (OSError, ValueError):  # stdin closed / not selectable
        return EOF_KEY
    if not ready:
        return None
    line = sys.stdin.readline()
    if line == "":
        return EOF_KEY
    stripped = line.strip()
    return stripped[:1].lower() if stripped else "\n"


class PlaybackController:
    """Frame-advance state machine (ref FrameContext semantics).

    States: `auto_play` (frames flow freely) vs stepping (wait for an
    advance). `wait_for_advance()` is called once per frame by the player
    loop and returns False when the user quit.
    """

    def __init__(self, step_mode: bool, key_source=None, poll_s: float = 0.05,
                 log=None):
        self.step_mode = step_mode
        self.auto_play = not step_mode
        self.quit = False
        self._keys = key_source if key_source is not None else (
            lambda timeout: _poll_stdin(timeout))
        self._poll_s = poll_s
        self._log = log

    def _handle(self, key) -> bool:
        """Apply one key. Returns True if the frame should advance now."""
        if key is None:
            return False
        if key == EOF_KEY:
            # No key can ever arrive again. Stepping cannot advance -> quit;
            # auto-play needs no keys -> keep playing, stop polling.
            self._keys = lambda timeout: None
            if not self.auto_play:
                if self._log:
                    self._log.info("stdin closed while stepping — quitting")
                self.quit = True
            return True
        if key == "q":
            self.quit = True
            return True
        if key == "a":
            self.auto_play = not self.auto_play
            if self._log:
                self._log.info("auto-play %s",
                               "ON" if self.auto_play else "OFF (stepping)")
            return self.auto_play
        # enter / space / any other key = advance one frame
        return True

    def wait_for_advance(self) -> bool:
        """Block (politely) until the next frame may run.

        Auto-play: one non-blocking poll (so 'a'/'q' stay responsive), then
        advance. Stepping: poll until a key arrives. Returns False on quit.
        """
        if not self.step_mode:
            return True
        if self.auto_play:
            self._handle(self._keys(0.0))
            return not self.quit
        while not self.quit:
            if self._handle(self._keys(self._poll_s)):
                break
        return not self.quit
