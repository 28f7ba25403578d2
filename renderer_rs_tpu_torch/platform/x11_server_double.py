"""Scripted X-server double (≙ renderer_rs_tpu/platform/x11_server_double.py):
a Unix-socket server speaking enough of the X11 wire protocol to drive the
real `platform.x11.X11Window` (and the libX11/xcb stack under it) end to
end on a machine without an X server.

It performs the connection handshake, consumes requests with correct
sequence accounting, replies to the round-trip requests Xlib needs
(QueryExtension, InternAtom, GetInputFocus, GetKeyboardMapping,
GetModifierMapping, GetGeometry), records what the client did (windows
created, properties set, frames blitted by PutImage with their pixel
bytes) and injects scripted wire events (key, button, motion,
ClientMessage, ConfigureNotify) that the client then receives through
XPending/XNextEvent. It implements the X11 protocol, not an X server: no
rendering, no window management, one client, little-endian only.

It listens in the Linux abstract socket namespace, on the address libxcb
tries first for display :N ("\\0/tmp/.X11-unix/XN"), so it creates no
file; the display number is the first free one from `display_num` up.

Protocol references: X Window System Protocol (X11R7.7), chapters
"Connection Setup", "Requests", "Events". Request opcodes and wire
layouts follow Xproto.h.
"""

from __future__ import annotations

import errno
import socket
import struct
import threading

# --- request opcodes this double understands (Xproto.h) -------------------
OP_CREATE_WINDOW = 1
OP_CHANGE_WINDOW_ATTRIBUTES = 2
OP_DESTROY_WINDOW = 4
OP_MAP_WINDOW = 8
OP_GET_GEOMETRY = 14
OP_INTERN_ATOM = 16
OP_CHANGE_PROPERTY = 18
OP_GET_PROPERTY = 20
OP_GET_INPUT_FOCUS = 43
OP_CREATE_GC = 55
OP_FREE_GC = 60
OP_PUT_IMAGE = 72
OP_QUERY_EXTENSION = 98
OP_GET_KEYBOARD_MAPPING = 101
OP_GET_MODIFIER_MAPPING = 119

# --- wire event codes -----------------------------------------------------
EV_KEY_PRESS = 2
EV_KEY_RELEASE = 3
EV_BUTTON_PRESS = 4
EV_BUTTON_RELEASE = 5
EV_MOTION_NOTIFY = 6
EV_CONFIGURE_NOTIFY = 22
EV_CLIENT_MESSAGE = 33

# display numbers tried from the first asked for
_DISPLAY_TRIES = 256

_ROOT_WINDOW = 0x0000_0173
_ROOT_VISUAL = 0x0000_0021


def _abstract_address(num: int) -> str:
    """The abstract-namespace address libxcb connects to for display :num."""
    return f"\0/tmp/.X11-unix/X{num}"


def _pad4(n: int) -> int:
    return (4 - (n % 4)) % 4


class X11ServerDouble:
    """One-client scripted X server on a Unix socket.

    Usage::

        with X11ServerDouble() as srv:
            win = X11Window(64, 48, "t", display=srv.display)  # real libX11
            win.present(frame)                    # real XPutImage
            srv.inject_motion(10, 12)             # scripted event
            win.pump_events(input_state)          # real XNextEvent path
        # assertions on srv.put_images / srv.windows / srv.properties
    """

    def __init__(self, display_num: int = 100, keysym_table: dict | None = None):
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        for num in range(display_num, display_num + _DISPLAY_TRIES):
            try:
                self._sock.bind(_abstract_address(num))
                break
            except OSError as e:
                if e.errno != errno.EADDRINUSE:
                    raise
        else:
            self._sock.close()
            raise OSError(f"no free X display from :{display_num}")
        self.display_num = num
        self.display = f":{num}"
        # recorded client activity, appended by the server thread
        self.requests: list[tuple] = []  # (opcode, seq)
        self.windows: dict[int, dict] = {}  # wid -> attrs
        self.mapped: list[int] = []
        self.atoms: dict[str, int] = {}
        self.properties: list[dict] = []
        self.put_images: list[dict] = []  # drawable/gc/w/h/depth/data
        self.event_masks: dict[int, int] = {}
        self.destroyed: list[int] = []
        # keycode -> keysym for GetKeyboardMapping (the defaults cover the
        # app's movement keys through platform.x11._KEYSYM_TO_KEYCODE)
        self.keysyms = keysym_table or {
            25: 0x0077, 38: 0x0061, 39: 0x0073, 40: 0x0064,  # w a s d
            24: 0x0071, 26: 0x0065, 65: 0x0020, 9: 0xFF1B,   # q e space esc
        }
        self._seq = 0
        self._client: socket.socket | None = None
        self._lock = threading.Lock()
        self._handshake_done = threading.Event()
        self._closed = False
        self._sock.listen(1)
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    # --- lifecycle --------------------------------------------------------
    def __enter__(self) -> "X11ServerDouble":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Stop serving: shut both sockets down (which wakes the server
        thread's accept or recv) and join the thread."""
        self._closed = True
        with self._lock:
            socks = [self._sock] + ([self._client] if self._client is not None else [])
        for sock in socks:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            sock.close()
        self._thread.join(timeout=5.0)

    def wait_connected(self, timeout: float = 5.0) -> bool:
        return self._handshake_done.wait(timeout)

    # --- scripted event injection ----------------------------------------
    def _send(self, data: bytes) -> None:
        with self._lock:
            if self._client is None:
                raise RuntimeError("no client connected")
            self._client.sendall(data)

    def _event_header(self, code: int, detail: int) -> bytes:
        return struct.pack("<BBH", code, detail, self._seq & 0xFFFF)

    def inject_input(self, code: int, detail: int, x: int, y: int) -> None:
        """Key/button/motion wire event at window coords (x, y)."""
        wid = self.mapped[-1] if self.mapped else _ROOT_WINDOW
        self._send(
            self._event_header(code, detail)
            + struct.pack(
                "<IIIIhhhhHBx",
                0,  # time
                _ROOT_WINDOW, wid, 0,  # root, event, child
                0, 0, x, y,  # root-x/y, event-x/y
                0, 1,  # state, same-screen
            )
        )

    def inject_motion(self, x: int, y: int) -> None:
        self.inject_input(EV_MOTION_NOTIFY, 0, x, y)

    def inject_key(self, keycode: int, press: bool = True) -> None:
        self.inject_input(EV_KEY_PRESS if press else EV_KEY_RELEASE, keycode, 0, 0)

    def inject_button(self, button: int, press: bool = True, x: int = 0, y: int = 0) -> None:
        self.inject_input(
            EV_BUTTON_PRESS if press else EV_BUTTON_RELEASE, button, x, y
        )

    def inject_configure(self, width: int, height: int) -> None:
        wid = self.mapped[-1] if self.mapped else _ROOT_WINDOW
        self._send(
            self._event_header(EV_CONFIGURE_NOTIFY, 0)
            + struct.pack(
                "<IIIhhHHHBxxxxx",
                wid, wid, 0,  # event, window, above-sibling
                0, 0, width, height, 1,  # x, y, w, h, border
                0,  # override-redirect
            )
        )

    def inject_close(self) -> None:
        """WM_DELETE_WINDOW ClientMessage (≙ the WM close button)."""
        wid = self.mapped[-1] if self.mapped else _ROOT_WINDOW
        proto = self.atoms.get("WM_PROTOCOLS", 0)
        delete = self.atoms.get("WM_DELETE_WINDOW", 0)
        self._send(
            self._event_header(EV_CLIENT_MESSAGE, 32)
            + struct.pack("<II", wid, proto)
            + struct.pack("<I", delete)
            + b"\x00" * 16
        )

    # --- server thread ----------------------------------------------------
    def _serve(self) -> None:
        try:
            client, _ = self._sock.accept()
        except OSError:
            return  # closed before any connection
        with self._lock:
            self._client = client
        try:
            self._handshake(client)
            self._handshake_done.set()
            while not self._closed:
                head = self._recv_exact(client, 4)
                if head is None:
                    return
                opcode, data_b, length = struct.unpack("<BBH", head)
                body = self._recv_exact(client, length * 4 - 4) if length > 1 else b""
                if body is None:
                    return
                self._seq += 1
                self.requests.append((opcode, self._seq))
                self._dispatch(client, opcode, data_b, body)
        except OSError:
            return

    def _recv_exact(self, sock: socket.socket, n: int) -> bytes | None:
        buf = b""
        while len(buf) < n:
            try:
                chunk = sock.recv(n - len(buf))
            except OSError:
                return None
            if not chunk:
                return None
            buf += chunk
        return buf

    def _handshake(self, client: socket.socket) -> None:
        head = self._recv_exact(client, 12)
        if head is None:
            raise OSError("client vanished during setup")
        order = head[0:1]
        if order != b"l":
            raise OSError("double speaks little-endian only")
        # order(1) pad(1) major(2) minor(2) auth-name-len(2) auth-data-len(2) pad(2)
        _major, _minor, auth_name_len, auth_data_len = struct.unpack(
            "<HHHH", head[2:10]
        )
        auth = auth_name_len + _pad4(auth_name_len) + auth_data_len + _pad4(
            auth_data_len
        )
        if auth and self._recv_exact(client, auth) is None:
            raise OSError("client vanished during auth")
        client.sendall(self._setup_reply())

    def _setup_reply(self) -> bytes:
        vendor = b"renderer_rs_tpu_torch scripted double"
        vpad = _pad4(len(vendor))
        # depth 24 visual (TrueColor) — what XDefaultVisual/Depth return
        visual = struct.pack(
            "<IBBHIIIxxxx", _ROOT_VISUAL, 4, 8, 256,
            0x00FF0000, 0x0000FF00, 0x000000FF,
        )
        depth = struct.pack("<BxHxxxx", 24, 1) + visual
        screen = struct.pack(
            "<IIIIIHHHHHHIBBBB",
            _ROOT_WINDOW,  # root
            0x22,  # default colormap
            0xFFFFFF, 0x000000,  # white, black pixel
            0,  # current input masks
            1920, 1080, 508, 285,  # px / mm
            1, 1,  # installed maps
            _ROOT_VISUAL,
            0, 0,  # backing stores, save-unders
            24,  # root depth
            1,  # allowed depths
        ) + depth
        formats = (
            struct.pack("<BBBxxxxx", 1, 1, 32)
            + struct.pack("<BBBxxxxx", 24, 32, 32)
            + struct.pack("<BBBxxxxx", 32, 32, 32)
        )
        payload = struct.pack(
            "<IIIIHHBBBBBBBBxxxx",
            11_0000_00,  # release
            0x00200000, 0x001FFFFF,  # resource id base/mask
            256,  # motion buffer
            len(vendor),
            0xFFFF,  # max request length (4-byte units)
            1,  # screens
            3,  # formats
            0, 0,  # image byte order LSB, bitmap bit order LSB
            32, 32,  # scanline unit / pad
            8, 255,  # min / max keycode
        ) + vendor + b"\x00" * vpad + formats + screen
        assert len(payload) % 4 == 0
        return (
            struct.pack("<BxHHH", 1, 11, 0, len(payload) // 4) + payload
        )

    # --- request dispatch -------------------------------------------------
    def _reply(self, data1: int, payload: bytes = b"", extra_len: int = 0) -> bytes:
        """32-byte reply header + payload. data1 is the byte at offset 1."""
        body = payload + b"\x00" * (24 - len(payload)) if len(payload) <= 24 else payload
        return struct.pack(
            "<BBHI", 1, data1, self._seq & 0xFFFF, extra_len
        ) + body

    def _dispatch(self, client, opcode: int, data_b: int, body: bytes) -> None:
        if opcode == OP_CREATE_WINDOW:
            wid, parent, x, y, w, h, border, wclass, visual, value_mask = (
                struct.unpack_from("<IIhhHHHHII", body)
            )
            self.windows[wid] = dict(
                parent=parent, x=x, y=y, width=w, height=h, depth=data_b
            )
        elif opcode == OP_CHANGE_WINDOW_ATTRIBUTES:
            wid, value_mask = struct.unpack_from("<II", body)
            if value_mask & 0x0800:  # CWEventMask
                self.event_masks[wid] = struct.unpack_from("<I", body, 8)[0]
        elif opcode == OP_MAP_WINDOW:
            (wid,) = struct.unpack_from("<I", body)
            self.mapped.append(wid)
        elif opcode == OP_DESTROY_WINDOW:
            (wid,) = struct.unpack_from("<I", body)
            self.destroyed.append(wid)
        elif opcode == OP_INTERN_ATOM:
            (nlen,) = struct.unpack_from("<H", body)
            name = body[4 : 4 + nlen].decode("latin-1")
            atom = self.atoms.setdefault(name, 0x100 + len(self.atoms))
            client.sendall(self._reply(0, struct.pack("<I", atom)))
        elif opcode == OP_CHANGE_PROPERTY:
            wid, prop, ptype, fmt = struct.unpack_from("<IIIB", body)
            (nitems,) = struct.unpack_from("<I", body, 16)
            nbytes = nitems * (fmt // 8)
            self.properties.append(
                dict(window=wid, property=prop, type=ptype,
                     data=body[20 : 20 + nbytes])
            )
        elif opcode == OP_GET_PROPERTY:
            client.sendall(self._reply(0, struct.pack("<III", 0, 0, 0)))
        elif opcode == OP_GET_GEOMETRY:
            (wid,) = struct.unpack_from("<I", body)
            info = self.windows.get(wid, dict(x=0, y=0, width=1920, height=1080))
            client.sendall(
                self._reply(
                    24,
                    struct.pack(
                        "<Ihhhhh",
                        _ROOT_WINDOW, info["x"], info["y"],
                        info["width"], info["height"], 1,
                    ),
                )
            )
        elif opcode == OP_GET_INPUT_FOCUS:  # XSync rides this
            client.sendall(self._reply(0, struct.pack("<I", _ROOT_WINDOW)))
        elif opcode == OP_PUT_IMAGE:
            drawable, gc, w, h, dx, dy, left_pad, depth = struct.unpack_from(
                "<IIHHhhBB", body
            )
            self.put_images.append(
                dict(
                    format=data_b, drawable=drawable, gc=gc,
                    width=w, height=h, dst_x=dx, dst_y=dy, depth=depth,
                    data=body[20 : 20 + h * ((w * 32 + 31) // 32) * 4],
                )
            )
        elif opcode == OP_QUERY_EXTENSION:
            # every extension is absent: keeps Xlib on the core protocol
            client.sendall(self._reply(0, struct.pack("<BBBB", 0, 0, 0, 0)))
        elif opcode == OP_GET_KEYBOARD_MAPPING:
            first, count = struct.unpack_from("<BB", body)
            syms = [self.keysyms.get(first + i, 0) for i in range(count)]
            payload = b"".join(struct.pack("<I", s) for s in syms)
            client.sendall(
                struct.pack("<BBHI", 1, 1, self._seq & 0xFFFF, count)
                + b"\x00" * 24
                + payload
            )
        elif opcode == OP_GET_MODIFIER_MAPPING:
            # Xlib's _XKeyInitialize fetches this alongside the keyboard
            # mapping; 1 keycode per modifier, all unbound
            client.sendall(
                struct.pack("<BBHI", 1, 1, self._seq & 0xFFFF, 2)
                + b"\x00" * 24
                + b"\x00" * 8
            )
        # all other requests (CreateGC, FreeGC, NoOperation, ...) have no
        # reply: consuming them with correct sequence accounting is enough
