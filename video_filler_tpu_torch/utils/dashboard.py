"""Live training dashboard, copied from video_filler_tpu/utils/dashboard.py
(the port imports nothing of the JAX package): the reference's `display`
rock equivalent.

The reference pushes image panes to a little HTTP server (`display` rock;
started via ``th -ldisplay.start``, panes pushed every display_iter,
train.lua:427-445, port config train_mycrit.lua:358-361).  Here the trainer
already writes PNG grids (utils/io.py) and JSONL metrics (utils/logger.py);
this module serves both live over HTTP from a background thread:

  /            auto-refreshing HTML: loss curves (client-drawn) + newest grids
  /metrics     last N JSONL records as a JSON array
  /imgs        JSON list of available grid PNGs (newest first)
  /img/<name>  a PNG from the display directory

Enable with ``displayServer=1`` (port = the reference's ``display_port``
option); PNG/JSONL dumps happen regardless — the server only adds a view.
"""

from __future__ import annotations

import json
import os
import threading
from http.server import ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from video_filler_tpu_torch.utils.httpbase import QuietHandler

_PAGE = """<!doctype html><html><head><title>video_filler_tpu — {name}</title>
<style>
 body {{ font-family: sans-serif; margin: 1.2em; background: #111; color: #eee; }}
 img {{ max-width: 30%; margin: 2px; border: 1px solid #333; }}
 canvas {{ background: #181818; border: 1px solid #333; }}
 h2 {{ font-weight: normal; }}
</style></head><body>
<h2>{name}</h2>
<canvas id="c" width="900" height="240"></canvas>
<div id="imgs"></div>
<script>
async function tick() {{
  const ms = await (await fetch('/metrics?n=400')).json();
  const keys = ['errG_l2', 'errG', 'errD'];
  const colors = ['#6cf', '#fc6', '#f66'];
  const c = document.getElementById('c'), g = c.getContext('2d');
  g.clearRect(0, 0, c.width, c.height);
  const pts = ms.filter(m => m.errD !== undefined);
  if (pts.length > 1) {{
    let max = 0;
    for (const m of pts) for (const k of keys) max = Math.max(max, m[k] ?? 0);
    keys.forEach((k, ki) => {{
      g.strokeStyle = colors[ki]; g.beginPath();
      pts.forEach((m, i) => {{
        const x = i / (pts.length - 1) * (c.width - 20) + 10;
        const y = c.height - 15 - (m[k] ?? 0) / max * (c.height - 30);
        i ? g.lineTo(x, y) : g.moveTo(x, y);
      }});
      g.stroke();
      g.fillStyle = colors[ki]; g.fillText(k, 12 + ki * 80, 12);
    }});
  }}
  const imgs = await (await fetch('/imgs')).json();
  document.getElementById('imgs').innerHTML =
    imgs.slice(0, 9).map(f => `<img src="/img/${{f}}" title="${{f}}">`).join('');
}}
tick(); setInterval(tick, 3000);
</script></body></html>"""


class Dashboard:
    """Threaded HTTP server over the trainer's JSONL + PNG artifacts."""

    def __init__(self, name: str, log_dir: str = "logs",
                 img_dir: str = "display", port: int = 8000):
        self.name = name
        self.jsonl = os.path.join(log_dir, f"{name}.jsonl")
        self.img_dir = img_dir
        dash = self

        class Handler(QuietHandler):
            def do_GET(self):
                url = urlparse(self.path)
                if url.path == "/":
                    self._send(200, "text/html",
                               _PAGE.format(name=dash.name).encode())
                elif url.path == "/metrics":
                    try:
                        n = int(parse_qs(url.query).get("n", ["200"])[0])
                    except ValueError:
                        self._send(400, "text/plain",
                                   b"n must be an integer")
                        return
                    n = max(n, 0)  # a negative n would flip the tail slice
                    self._send(200, "application/json",
                               json.dumps(dash.read_metrics(n)).encode())
                elif url.path == "/imgs":
                    self._send(200, "application/json",
                               json.dumps(dash.list_images()).encode())
                elif url.path.startswith("/img/"):
                    fn = os.path.basename(url.path[5:])
                    p = os.path.join(dash.img_dir, fn)
                    if os.path.isfile(p) and fn.endswith(".png"):
                        with open(p, "rb") as f:
                            self._send(200, "image/png", f.read())
                    else:
                        self._send(404, "text/plain", b"not found")
                else:
                    self._send(404, "text/plain", b"not found")

        # localhost-only: training metrics/grids must not be exposed to the
        # network of a shared host (tunnel in for remote viewing).
        self._srv = ThreadingHTTPServer(("localhost", port), Handler)
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()

    def read_metrics(self, n: int) -> list[dict]:
        if not os.path.isfile(self.jsonl):
            return []
        # Tail-read: long runs grow the JSONL to tens of MB; polling must not
        # re-read the whole file every few seconds on the training host.
        # Lines have no fixed width (regimes log different metric sets), so
        # grow the window until it spans n complete lines or the whole file.
        with open(self.jsonl, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            window = 256 * (n + 1)
            while True:
                start = max(size - window, 0)
                f.seek(start)
                chunk = f.read().decode("utf-8", "replace")
                lines = chunk.splitlines()
                if start > 0 and lines:
                    lines = lines[1:]  # drop the partial line of a mid-seek
                if start == 0 or len(lines) > n:
                    break
                window *= 4
        lines = lines[-n:]
        out = []
        for ln in lines:
            try:
                out.append(json.loads(ln))
            except json.JSONDecodeError:
                pass
        return out

    def list_images(self) -> list[str]:
        if not os.path.isdir(self.img_dir):
            return []
        files = [f for f in os.listdir(self.img_dir)
                 if f.endswith(".png") and f.startswith(self.name)]
        files.sort(key=lambda f: os.path.getmtime(
            os.path.join(self.img_dir, f)), reverse=True)
        return files

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        self._thread.join(timeout=2.0)
