"""Session-based inference API for the demo server.

Counterpart of `sam2_opt_tpu/serve/inference_api.py`, over the port's video
predictor. Re-design of sam2/demo/backend/server/inference/predictor.py:43-430
(InferenceAPI): a session dict mapping session_id -> video predictor
inference_state, with start/close session, add_points, add_mask,
clear_points, remove_object, and a streaming propagate_in_video that yields
per-frame RLE masks (the reference streams multipart chunked RLE,
inference/multipart.py). Thread safety: a global lock guards the session
dict; a per-session lock serializes every state-mutating call on one
session, INCLUDING the whole streamed propagation (so a concurrent
add_points/remove_object cannot re-index the state mid-stream). Different
sessions run concurrently; cancellation takes only the global lock and is
never blocked by a running stream. After `predictor.speedup()` the tracking
steps are CUDA graph replays; the graph executor serialises replays across
sessions with its own lock, so sessions share the graphs safely.
"""

from __future__ import annotations

import threading
import uuid
from typing import Dict, Generator, List, Optional

import numpy as np

from sam2_opt_tpu_torch.utils.amg import mask_to_rle, rle_to_mask


class InferenceAPI:
    def __init__(self, predictor, score_thresh: float = 0.0,
                 max_sessions: int = 16):
        self.predictor = predictor
        self.score_thresh = score_thresh
        self.max_sessions = max_sessions
        self.session_states: Dict[str, dict] = {}
        self._lock = threading.RLock()

    # ------------------------------------------------------------------ #

    def start_session(self, video_path) -> str:
        """Load a video and create a tracking session (reference :100-115)."""
        with self._lock:
            if len(self.session_states) >= self.max_sessions:
                # GC the oldest session (reference session GC)
                oldest = next(iter(self.session_states))
                self.session_states.pop(oldest)
            session_id = str(uuid.uuid4())
            state = self.predictor.init_state(video_path)
            self.session_states[session_id] = {
                # monotone cancellation generation: each stream captures the
                # value at start and aborts when it changes. A cancel is an
                # increment, never a reset — so cancel-then-restart cannot
                # overwrite a cancel aimed at the still-running old stream
                # (which holds the session lock until it observes the bump).
                "cancel_gen": 0,
                "state": state,
                # plain Lock (not RLock): held across a whole streamed
                # propagation by the handler thread; a plain Lock may be
                # released from whichever thread runs the generator cleanup
                "lock": threading.Lock(),
            }
            return session_id

    def close_session(self, session_id: str) -> bool:
        with self._lock:
            return self.session_states.pop(session_id, None) is not None

    def _get_session(self, session_id: str) -> dict:
        session = self.session_states.get(session_id)
        if session is None:
            raise RuntimeError(
                f"Cannot find session {session_id}; it might have expired"
            )
        return session

    # ------------------------------------------------------------------ #

    def add_points(self, session_id: str, frame_index: int, object_id: int,
                   points: List[List[float]], labels: List[int],
                   clear_old_points: bool = True) -> dict:
        """reference :120-153; returns per-object RLE masks on that frame."""
        with self._lock:
            session = self._get_session(session_id)
        with session["lock"]:
            frame_idx, obj_ids, masks = self.predictor.add_new_points_or_box(
                session["state"], frame_index, object_id,
                points=np.asarray(points, np.float32),
                labels=np.asarray(labels, np.int32),
                clear_old_points=clear_old_points,
            )
            return self._frame_response(frame_idx, obj_ids, masks)

    def add_mask(self, session_id: str, frame_index: int, object_id: int,
                 mask_rle: dict) -> dict:
        """reference :155-193; mask given as uncompressed RLE."""
        with self._lock:
            session = self._get_session(session_id)
        with session["lock"]:
            mask = rle_to_mask(mask_rle)
            frame_idx, obj_ids, masks = self.predictor.add_new_mask(
                session["state"], frame_index, object_id, mask
            )
            return self._frame_response(frame_idx, obj_ids, masks)

    def clear_points_in_frame(self, session_id: str, frame_index: int,
                              object_id: int) -> dict:
        with self._lock:
            session = self._get_session(session_id)
        with session["lock"]:
            out = self.predictor.clear_all_prompts_in_frame(
                session["state"], frame_index, object_id
            )
            if out is None:
                return {"frameIndex": frame_index, "results": []}
            return self._frame_response(*out)

    def clear_points_in_video(self, session_id: str) -> bool:
        with self._lock:
            session = self._get_session(session_id)
        with session["lock"]:
            self.predictor.reset_state(session["state"])
            return True

    def remove_object(self, session_id: str, object_id: int) -> list:
        with self._lock:
            session = self._get_session(session_id)
        with session["lock"]:
            obj_ids, updated = self.predictor.remove_object(
                session["state"], object_id
            )
            return [
                self._frame_response(t, obj_ids, masks) for t, masks in updated
            ]

    def propagate_in_video(self, session_id: str,
                           start_frame_index: int = 0) -> Generator[dict, None, None]:
        """Streamed tracking (reference :270-355): yields one dict of RLE
        masks per frame; cancellable via cancel_propagate_in_video."""
        with self._lock:
            session = self._get_session(session_id)
            my_gen = session["cancel_gen"]
            state = session["state"]
        # hold the SESSION lock for the entire stream: concurrent
        # add_points/add_mask/remove_object on the same session would
        # otherwise re-index the state the propagation loop is iterating
        # (cancel_propagate_in_video needs only the global lock, so
        # cancellation is never blocked)
        with session["lock"]:
            for frame_idx, obj_ids, masks in self.predictor.propagate_in_video(
                state, start_frame_idx=start_frame_index
            ):
                if session["cancel_gen"] != my_gen:
                    return
                yield self._frame_response(frame_idx, obj_ids, masks)

    def cancel_propagate_in_video(self, session_id: str) -> bool:
        with self._lock:
            self._get_session(session_id)["cancel_gen"] += 1
            return True

    # ------------------------------------------------------------------ #

    def _frame_response(self, frame_idx, obj_ids, masks) -> dict:
        masks_np = (masks > self.score_thresh).cpu().numpy()  # [N, 1, H, W]
        results = []
        for i, obj_id in enumerate(obj_ids):
            rle = mask_to_rle(masks_np[i])[0]
            results.append(
                {
                    "objectId": int(obj_id) if not isinstance(obj_id, str) else obj_id,
                    "mask": {"size": rle["size"], "counts": rle["counts"]},
                }
            )
        return {"frameIndex": int(frame_idx), "results": results}

    def session_stats(self) -> dict:
        """The number of sessions and the graph executor's counters
        (`core/executor.py`): per seam its replays, captures and the bytes
        copied in and out, and the seconds callers waited for its lock, which
        the sessions share."""
        with self._lock:
            n = len(self.session_states)
        return {"numSessions": n, "graphs": self.predictor.model.graphs.counters()}
