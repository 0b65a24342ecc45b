"""HTTP demo server (stdlib `http.server`, no web framework).

Counterpart of `sam2_opt_tpu/serve/server.py`. Re-design of sam2/demo/backend/server/app.py:29-130: JSON endpoints over the
InferenceAPI, with /propagate_in_video streamed as newline-delimited JSON
frames (standing in for the reference's multipart chunked RLE stream,
inference/multipart.py). Endpoints:

  GET  /healthy                  -> {"ok", "numSessions", "graphs": {"captures",
                                  "lock_wait_s", "seams": {<seam>: {"replays",
                                  "captures", "copy_in_bytes", "copy_out_bytes"}}}}
  POST /start_session            {"video_path": ...} -> {"sessionId": ...}
  POST /close_session            {"sessionId": ...}
  POST /add_points               {"sessionId", "frameIndex", "objectId",
                                  "points": [[x,y]...], "labels": [...]}
  POST /add_mask                 {"sessionId", "frameIndex", "objectId",
                                  "mask": {"size": [h,w], "counts": [...]}}
  POST /clear_points_in_frame    {"sessionId", "frameIndex", "objectId"}
  POST /clear_points_in_video    {"sessionId"}
  POST /remove_object            {"sessionId", "objectId"}
  POST /propagate_in_video       {"sessionId", "startFrameIndex"}  (NDJSON stream)
  POST /cancel_propagate_in_video {"sessionId"}
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from sam2_opt_tpu_torch.serve.inference_api import InferenceAPI


def make_handler(api: InferenceAPI):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet
            pass

        def _json(self, status: int, payload):
            body = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Access-Control-Allow-Origin", "*")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthy":
                self._json(200, {"ok": True, **api.session_stats()})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError:
                self._json(400, {"error": "invalid JSON body"})
                return
            try:
                if self.path == "/start_session":
                    sid = api.start_session(req["video_path"])
                    self._json(200, {"sessionId": sid})
                elif self.path == "/close_session":
                    ok = api.close_session(req["sessionId"])
                    self._json(200, {"success": ok})
                elif self.path == "/add_points":
                    out = api.add_points(
                        req["sessionId"], req["frameIndex"], req["objectId"],
                        req["points"], req["labels"],
                        req.get("clearOldPoints", True),
                    )
                    self._json(200, out)
                elif self.path == "/add_mask":
                    out = api.add_mask(
                        req["sessionId"], req["frameIndex"], req["objectId"],
                        req["mask"],
                    )
                    self._json(200, out)
                elif self.path == "/clear_points_in_frame":
                    out = api.clear_points_in_frame(
                        req["sessionId"], req["frameIndex"], req["objectId"]
                    )
                    self._json(200, out)
                elif self.path == "/clear_points_in_video":
                    self._json(
                        200, {"success": api.clear_points_in_video(req["sessionId"])}
                    )
                elif self.path == "/remove_object":
                    self._json(200, {"results": api.remove_object(
                        req["sessionId"], req["objectId"])})
                elif self.path == "/cancel_propagate_in_video":
                    self._json(
                        200,
                        {"success": api.cancel_propagate_in_video(req["sessionId"])},
                    )
                elif self.path == "/propagate_in_video":
                    # NDJSON stream, one frame per line
                    self.send_response(200)
                    self.send_header("Content-Type", "application/x-ndjson")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.send_header("Access-Control-Allow-Origin", "*")
                    self.end_headers()
                    for frame in api.propagate_in_video(
                        req["sessionId"], req.get("startFrameIndex", 0)
                    ):
                        chunk = (json.dumps(frame) + "\n").encode()
                        self.wfile.write(f"{len(chunk):x}\r\n".encode())
                        self.wfile.write(chunk + b"\r\n")
                    self.wfile.write(b"0\r\n\r\n")
                else:
                    self._json(404, {"error": f"unknown endpoint {self.path}"})
            except KeyError as e:
                self._json(400, {"error": f"missing field {e}"})
            except RuntimeError as e:
                status = 404 if "Cannot find session" in str(e) else 500
                self._json(status, {"error": str(e)})
            except Exception as e:  # surface internal errors as 500 JSON
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


class DemoServer:
    def __init__(self, api: InferenceAPI, host: str = "127.0.0.1",
                 port: int = 7263):
        self.httpd = ThreadingHTTPServer((host, port), make_handler(api))
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start_background(self):
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def serve_forever(self):
        self.httpd.serve_forever()

    def shutdown(self):
        self.httpd.shutdown()


def main():
    """`python -m sam2_opt_tpu_torch.serve.server`: a video predictor on the
    card (random weights unless --checkpoint names a reference `.pt`), after
    `speedup()` unless --backend eager."""
    import argparse

    from sam2_opt_tpu_torch.build_sam import build_sam2_video_predictor

    parser = argparse.ArgumentParser()
    parser.add_argument("--variant", default="hiera_l")
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=7263)
    parser.add_argument("--backend", default="cuda", choices=("cuda", "eager"))
    args = parser.parse_args()

    predictor = build_sam2_video_predictor(args.variant, args.checkpoint)
    if args.backend != "eager":
        predictor.speedup()
    api = InferenceAPI(predictor)
    server = DemoServer(api, args.host, args.port)
    print(f"demo server listening on {args.host}:{server.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
