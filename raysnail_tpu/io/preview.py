"""Live render preview over HTTP.

The reference opens an SDL2 window and streams finished rows to it over an
mpsc channel (src/bin/raysnail.rs:211-308, src/painter.rs:214); closing the
window cancels the render. A GPU server is headless, so the preview is a tiny
local HTTP server instead: an auto-refreshing page shows the accumulating
image, and `PreviewServer.target` plugs into the same streaming-callback slot
(`RenderSession.render(target=...)` / `render_passes(progress=...)`) that
plays the role of the reference's PainterTarget (painter.rs:23-26). DELETE
/ (or ctrl-C) cancels like the reference's window close -> Quit command
(raysnail.rs:304-307) — except here the render loop actually polls it.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = b"""<!doctype html>
<html><head><title>raysnail-tpu live preview</title><style>
body { background:#181b1f; color:#d8dde3; font:14px monospace; margin:2em }
img { image-rendering:pixelated; border:1px solid #333; max-width:95vw }
</style></head><body>
<div id=s>waiting for first chunk...</div>
<p><img id=f src="/frame.png"></p>
<script>
async function tick() {
  try {
    const r = await fetch('/status'); const s = await r.json();
    document.getElementById('s').textContent =
      `pass ${s.pass} - ${s.done}/${s.total} samples` +
      (s.mrays ? ` - ${s.mrays.toFixed(2)} Mrays/s` : '');
    if (s.frame != window._last) {
      window._last = s.frame;
      document.getElementById('f').src = '/frame.png?v=' + s.frame;
    }
  } catch (e) {}
  setTimeout(tick, 500);
}
tick();
</script></body></html>
"""


class PreviewServer:
    """Serves / (page), /frame.png (latest image), /status (progress JSON)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8765):
        self._lock = threading.Lock()
        self._png: bytes | None = None
        self._frame = 0
        self._status = {"done": 0, "total": 0, "pass": 0, "mrays": 0.0,
                        "frame": 0}
        self.cancelled = False
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence request logging
                pass

            def do_GET(self):
                if self.path.startswith("/frame.png"):
                    with outer._lock:
                        png = outer._png
                    if png is None:
                        self.send_response(404)
                        self.end_headers()
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Cache-Control", "no-store")
                    self.end_headers()
                    self.wfile.write(png)
                elif self.path.startswith("/status"):
                    with outer._lock:
                        body = json.dumps(outer._status).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.end_headers()
                    self.wfile.write(_PAGE)

            def do_DELETE(self):
                outer.cancelled = True
                self.send_response(200)
                self.end_headers()

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_port
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    # -- producer side ------------------------------------------------------
    def update(self, img: np.ndarray, done: int = 0, total: int = 0,
               pass_index: int = 0, mrays: float = 0.0) -> None:
        """img: (H, W, 3) float in [0,1] (gamma already applied)."""
        from PIL import Image

        from raysnail_tpu.prelude import color as colorlib

        buf = io.BytesIO()
        Image.fromarray(colorlib.to_u8(np.asarray(img))).save(buf, format="PNG")
        with self._lock:
            self._frame += 1
            self._png = buf.getvalue()
            self._status = {"done": int(done), "total": int(total),
                            "pass": int(pass_index), "mrays": float(mrays),
                            "frame": self._frame}

    def target(self, done: int, total: int, img: np.ndarray | None = None,
               pass_index: int = 0, mrays: float = 0.0):
        """RenderSession/render_passes streaming callback; False cancels."""
        if img is not None:
            self.update(img, done, total, pass_index, mrays)
        return not self.cancelled

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
