"""Shared HTTP handler plumbing for the inpaint server, copied from
video_filler_tpu/utils/httpbase.py: the silent access log and the ``_send``
response helper, which survives a client that disconnects mid-response.
"""

from __future__ import annotations

from http.server import BaseHTTPRequestHandler


class QuietHandler(BaseHTTPRequestHandler):
    def log_message(self, *a):  # quiet: per-request access logs would
        pass                    # swamp the training/serving stdout

    def _send(self, code: int, ctype: str, body: bytes) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        try:
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away mid-response; nothing to salvage
