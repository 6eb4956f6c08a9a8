"""leansdrserv-compatible network supervisor (reference
src/apps/leansdrserv.cc; a copy of leansdr_tpu/apps/leansdrserv.py).

Forks a pipeline command, intercepting the child's fd 1 (raw data),
fd 3 (tagged-line info) and fd 4 (control), and serving them over
one-shot HTTP listeners:
  --data1-httpd PORT      stream the child's stdout to the last client
  --info3-httpd PORT      JSON dump of ring-buffered info accumulators
  --control4-httpd PORT   forward the request line to the child's fd 4

Usage: python -m leansdr_tpu_torch.apps.leansdrserv [options] command args...
"""

import os
import select
import socket
import subprocess
import sys


class InfoBuffer:
    """Per-tag ring accumulators (infobuffer, leansdrserv.cc:32-80)."""

    def __init__(self):
        self.acc = {}        # tag -> (nlines, [lines])

    def put(self, tag: str, line: str):
        nlines, lines = self.acc.setdefault(tag, (1, []))
        if len(lines) == nlines:
            lines.pop(0)
        lines.append(line)

    def dump(self) -> str:
        parts = [f'"{tag}":[{",".join(lines)}]'
                 for tag, (_, lines) in self.acc.items()]
        return "{\n" + ",\n".join(parts) + "\n}"


def listener(port):
    if port < 0:
        return None
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("", port))
    s.listen(2)
    return s


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    data1 = info3 = control4 = -1
    verbose = False
    i = 0
    while i < len(argv) and argv[i].startswith("-"):
        a = argv[i]
        if a == "-h":
            print(__doc__, file=sys.stderr)
            return 0
        elif a == "-v":
            verbose = True
        elif a == "--data1-httpd":
            i += 1
            data1 = int(argv[i])
        elif a == "--info3-httpd":
            i += 1
            info3 = int(argv[i])
        elif a == "--control4-httpd":
            i += 1
            control4 = int(argv[i])
        else:
            print(f"** Error while processing '{a}'", file=sys.stderr)
            return 1
        i += 1
    command = argv[i:]
    if not command:
        print(__doc__, file=sys.stderr)
        return 1

    pass_fds = []
    fd3_r = fd3_w = fd4_r = fd4_w = None
    if info3 >= 0:
        fd3_r, fd3_w = os.pipe()
    if control4 >= 0:
        fd4_r, fd4_w = os.pipe()

    def preexec():
        if fd3_w is not None:
            os.dup2(fd3_w, 3)
        if fd4_r is not None:
            os.dup2(fd4_r, 4)

    child = subprocess.Popen(
        command,
        stdout=subprocess.PIPE if data1 >= 0 else None,
        close_fds=False,
        preexec_fn=preexec if (fd3_w is not None or fd4_r is not None)
        else None)
    for f in (fd3_w, fd4_r):
        if f is not None:
            os.close(f)

    infobuf = InfoBuffer()
    l_data = listener(data1)
    l_info = listener(info3)
    l_ctrl = listener(control4)
    out1 = 1        # forward child stdout here (replaced by HTTP client)
    buf3 = b""

    fds = []
    if child.stdout:
        fds.append(child.stdout.fileno())
    if fd3_r is not None:
        fds.append(fd3_r)
    fds += [s.fileno() for s in (l_data, l_info, l_ctrl) if s]

    while True:
        r, _, _ = select.select(fds, [], [])
        if child.stdout and child.stdout.fileno() in r:
            data = os.read(child.stdout.fileno(), 65536)
            if not data:
                return 0
            if out1 is not None:
                try:
                    os.write(out1, data)
                except OSError:
                    if out1 != 1:
                        os.close(out1)
                    out1 = None
        if fd3_r is not None and fd3_r in r:
            data = os.read(fd3_r, 65536)
            if not data:
                return 0
            buf3 += data
            while b"\n" in buf3:
                line, buf3 = buf3.split(b"\n", 1)
                if b" " in line:
                    tag, rest = line.split(b" ", 1)
                    infobuf.put(tag.decode(), rest.decode())
        if l_data and l_data.fileno() in r:
            conn, _ = l_data.accept()
            conn.sendall(b"HTTP/1.0 200 OK\r\n"
                         b"Content-Type: application/json\r\n"
                         b"Access-Control-Allow-Origin: *\r\n\r\n")
            if out1 not in (None, 1):
                os.close(out1)
            out1 = conn.detach()
        if l_info and l_info.fileno() in r:
            conn, _ = l_info.accept()
            # Drain the request before replying: closing with the
            # request unread makes strict clients see ECONNRESET.
            conn.settimeout(1.0)
            try:
                conn.recv(4096)
            except OSError:
                pass
            conn.sendall(b"HTTP/1.0 200 OK\r\n"
                         b"Content-Type: application/json\r\n"
                         b"Access-Control-Allow-Origin: *\r\n\r\n"
                         + infobuf.dump().encode())
            conn.close()
        if l_ctrl and l_ctrl.fileno() in r:
            conn, _ = l_ctrl.accept()
            f = conn.makefile("rwb")
            req = f.readline()
            if verbose:
                print(f"Control request: {req!r}", file=sys.stderr)
            os.write(fd4_w, req)
            while True:
                h = f.readline()
                if not h or h in (b"\r\n", b"\n"):
                    break
            f.write(b"HTTP/1.0 200 OK\r\n"
                    b"Content-Type: text/plain\r\n"
                    b"Access-Control-Allow-Origin: *\r\n\r\n"
                    b"ECHO: " + req)
            f.flush()
            # makefile() keeps the socket alive past conn.close();
            # close both so read-to-EOF clients see the response end.
            f.close()
            conn.close()


if __name__ == "__main__":
    sys.exit(main())
