"""mac-before-pickle: unpickling executes arbitrary code, so bytes read off
a socket must be authenticated BEFORE they reach ``pickle.loads``.

The RPC plane's contract (rpc.py module docstring): with a session token
installed, every frame carries a keyed-BLAKE2b MAC verified constant-time
before the payload is unpickled. This rule machine-checks the contract with
an intra-function taint walk: names assigned from stream/socket reads are
tainted; taint propagates through expressions; a ``pickle.loads`` of tainted
data must be lexically dominated by a verify call (``hmac.compare_digest`` /
``frame_verify``) that touches the same taint. Lexical order approximates
dominance — good enough for the straight-line receive paths this codebase
writes, and a false positive is an invitation to restructure the code so the
verify obviously precedes the unpickle.
"""
from __future__ import annotations

import ast

from ray_tpu_torch.analysis.engine import FileContext, Rule, dotted_name

# Methods whose return value is bytes read from a peer.
_READ_METHODS = frozenset(
    ("readexactly", "read", "readline", "readuntil", "recv",
     "recvfrom", "sock_recv")
)
# Methods that fill a caller-supplied buffer IN PLACE (return a byte count,
# not the bytes): the buffer argument is what gets tainted.
_READ_INTO_METHODS = frozenset(
    ("recv_into", "recvfrom_into", "sock_recv_into", "readinto")
)
_VERIFY_NAMES = frozenset(("compare_digest", "frame_verify", "verify"))
_LOADS = frozenset(("pickle.loads", "cloudpickle.loads", "marshal.loads"))


def _names_in(node: ast.AST):
    """Trackable value identities in an expression: bare names plus simple
    dotted attributes (``self.buf`` — wire bytes parked on an instance
    attribute must stay tainted)."""
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            yield n.id
        elif isinstance(n, ast.Attribute):
            dn = dotted_name(n)
            if dn:
                yield dn


def _contains_read_call(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if (
            isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute)
            and n.func.attr in _READ_METHODS
        ):
            return True
    return False


def _target_names(target: ast.AST):
    if isinstance(target, ast.Name):
        yield target.id
    elif isinstance(target, ast.Attribute):
        dn = dotted_name(target)
        if dn:
            yield dn
    elif isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            yield from _target_names(elt)
    elif isinstance(target, ast.Starred):
        yield from _target_names(target.value)


class MacBeforePickle(Rule):
    id = "mac-before-pickle"
    explanation = (
        "pickle.loads of network bytes without a preceding MAC verification "
        "— unpickling unauthenticated data is remote code execution"
    )

    def begin_file(self, ctx: FileContext) -> None:
        self._reset()

    def _reset(self) -> None:
        # Taint GROUPS (union-find over name VERSIONS): each socket read
        # opens a new group; expressions mixing groups merge them; a verify
        # call marks the groups it touches. pickle.loads is clean only when
        # every tainted name it consumes belongs to a verified group —
        # verifying one read does NOT whitelist a different, never-verified
        # read later in the same function. Assignment is a STRONG update:
        # the target name rebinds to a fresh element, so reusing a verified
        # name for a second read (`data = await reader.read(...)` again)
        # does not inherit the old group's verified status.
        self._root: dict = {}  # element -> parent element
        self._alias: dict = {}  # name -> current versioned element
        self._tainted: set = set()  # tainted elements
        self._verified: set = set()  # verified group roots
        self._fresh = 0

    def _key(self, name: str) -> str:
        return self._alias.get(name, name)

    def _rebind(self, name: str) -> str:
        self._fresh += 1
        key = self._alias[name] = f"{name}@{self._fresh}"
        return key

    # -- union-find ------------------------------------------------------
    def _find(self, name: str) -> str:
        path = []
        while self._root.get(name, name) != name:
            path.append(name)
            name = self._root[name]
        for p in path:
            self._root[p] = name
        return name

    def _union_groups(self, names) -> str:
        """Merge the taint GROUPS of ``names``. The merged group is verified
        only if EVERY constituent group was — mixing never-verified bytes
        into verified data poisons the result, it does not launder the
        unverified read."""
        roots = {self._find(n) for n in names}
        it = iter(roots)
        root = next(it)
        all_verified = root in self._verified
        for rn in it:
            all_verified = all_verified and rn in self._verified
            self._verified.discard(rn)
            self._root[rn] = root
        self._verified.discard(root)
        if all_verified:
            self._verified.add(root)
        return root

    def _attach(self, fresh, names) -> None:
        """Alias fresh name-versions into the (merged) group of ``names``
        WITHOUT touching its verified status — a rebinding like
        ``body = data[16:]`` is a new view of the same bytes, not new
        taint."""
        root = self._union_groups(names)
        for f in fresh:
            self._root[f] = root
        self._tainted.update(fresh)

    def visit(self, node: ast.AST, ctx: FileContext) -> None:
        # New outermost function = new taint region (visit fires before the
        # engine pushes the function scope, so an empty stack means THIS node
        # opens the region; nested defs share their outer function's region —
        # closures like executor thunks see the same bytes).
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not ctx.func_stack:
                self._reset()
            return
        # Every assignment shape can carry wire bytes: plain, annotated
        # (AnnAssign), and walrus (NamedExpr — the idiomatic
        # `while (data := await reader.read(...))` receive loop).
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.NamedExpr)):
            targets = set()
            for t in node.targets if isinstance(node, ast.Assign) else [node.target]:
                targets.update(_target_names(t))
            if not targets or node.value is None:
                return
            # Source groups resolve BEFORE the targets rebind (the value is
            # evaluated before the assignment takes effect).
            tainted_srcs = {
                self._key(n) for n in _names_in(node.value)
            } & self._tainted
            fresh = {self._rebind(t) for t in targets}
            # Read-call presence dominates: `payload = await reader.read(plen)`
            # is NEW wire bytes even when plen came from a verified header —
            # the length being authenticated says nothing about the payload.
            if _contains_read_call(node.value):
                self._attach(fresh, fresh)  # a NEW (unverified) taint group
            elif tainted_srcs:
                # Propagation: targets join the source group(s); mixing
                # several groups merges them (verified only if ALL were).
                self._attach(fresh, tainted_srcs)
            # Otherwise the rebind alone is the strong update: the name now
            # points at clean data regardless of its history.
            return
        # Accumulation (`buf += await reader.read(...)` — the idiomatic
        # chunked receive loop): the target keeps its old bytes plus the
        # value's, so its new group merges old + sources, and any read in
        # the value poisons verified status (fresh elements are unverified).
        if isinstance(node, ast.AugAssign):
            tnames = set(_target_names(node.target))
            if not tnames:
                return
            srcs = {self._key(n) for n in _names_in(node.value)} & self._tainted
            old = {self._key(n) for n in tnames} & self._tainted
            has_read = _contains_read_call(node.value)
            if not (srcs or old or has_read):
                return
            fresh = {self._rebind(t) for t in tnames}
            if has_read:
                self._tainted.update(fresh)
                self._union_groups(srcs | old | fresh)
            else:
                self._attach(fresh, srcs | old)
            return
        if not isinstance(node, ast.Call):
            return
        fn = node.func
        attr = fn.attr if isinstance(fn, ast.Attribute) else (
            fn.id if isinstance(fn, ast.Name) else ""
        )
        if attr in _READ_INTO_METHODS:
            # In-place fill: the supplied buffer now holds NEW wire bytes —
            # strong-update every name-ish argument into a fresh unverified
            # group (the rpc.py _read_raw_into shape).
            filled = set()
            for a in node.args:
                filled.update(_target_names(a))
            if filled:
                fresh = {self._rebind(n) for n in filled}
                self._attach(fresh, fresh)
            return
        arg_names = set()
        for a in node.args:
            arg_names.update(self._key(n) for n in _names_in(a))
        tainted_args = arg_names & self._tainted
        if dotted_name(fn) in _LOADS:
            # The most direct violation needs no assignment at all:
            # pickle.loads(await reader.readexactly(n)) — bytes straight off
            # the socket into the unpickler.
            if any(_contains_read_call(a) for a in node.args):
                ctx.report(self, node)
                return
            if any(self._find(n) not in self._verified for n in tainted_args):
                ctx.report(self, node)
            return
        if not tainted_args:
            return
        if attr in _VERIFY_NAMES:
            # Comparing a received tag against a digest of received bytes
            # authenticates every group the comparison touches (they are
            # bound together by the MAC) — merge and mark.
            self._verified.add(self._union_groups(tainted_args))
