"""The serve cell's client: sends a schedule of requests, open loop, to
the annotation server's Unix socket, and writes what came back.

    python3 serve_client.py SOCKET SCHEDULE START GRACE OUT

SCHEDULE is a JSON file ``{"requests": [[due_s, id, {protein: sequence}],
...], "keep": [protein ids whose scores to keep]}``; START the
``time.monotonic()`` instant that due times count from; GRACE the seconds
past the last due time to wait for replies. Each request goes out on its
own connection at its due time, from a thread of its own, however many are
still waiting. OUT gets, per request, when it was sent and answered
(seconds from START) and whether its reply named every protein, and the
kept proteins' replies. Standard library only.
"""

import json
import socket
import sys
import threading
import time


def _exchange(path: str, proteins: dict, timeout: float) -> dict:
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as sock:
        sock.settimeout(timeout)
        sock.connect(path)
        sock.sendall((json.dumps({"proteins": proteins}) + "\n").encode())
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = sock.recv(1 << 20)
            if not chunk:
                break
            buf += chunk
    return json.loads(buf.decode())


def main(argv) -> int:
    path, schedule_file, start, grace, out_file = argv
    start, grace = float(start), float(grace)
    schedule = json.loads(open(schedule_file, encoding="utf-8").read())
    keep = set(schedule["keep"])
    last_due = max((r[0] for r in schedule["requests"]), default=0.0)
    end = start + last_due + grace
    results, lock = {}, threading.Lock()

    def send(due, rid, proteins):
        sent = time.monotonic() - start
        entry = {"due": due, "sent": sent, "done": None, "ok": False}
        try:
            reply = _exchange(path, proteins,
                              max(end - time.monotonic(), 1.0))
            entry["done"] = time.monotonic() - start
            got = reply.get("results", {})
            entry["ok"] = "error" not in reply and set(got) == set(proteins)
            entry["kept"] = {p: got[p] for p in proteins
                             if p in keep and p in got}
        except (OSError, ValueError) as e:
            entry["error"] = f"{type(e).__name__}: {e}"
        with lock:
            results[rid] = entry

    threads = []
    for due, rid, proteins in schedule["requests"]:
        wait = start + due - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        t = threading.Thread(target=send, args=(due, rid, proteins),
                             daemon=True)
        t.start()
        threads.append(t)
    for t in threads:
        t.join(max(end - time.monotonic(), 0.0))
    with lock:
        snapshot = dict(results)
    with open(out_file, "w", encoding="utf-8") as f:
        json.dump(snapshot, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
