"""Intraprocedural control-flow graphs + forward dataflow (stdlib-only).

The simpler checkers are flow-INsensitive AST walks, which leaves whole
invariant families reviewable-but-not-checkable:
"this span ends on every exception path", "this rename is preceded by
an fsync on every path", "no sleep while the lock is held" are all
statements about PATHS, not about syntax.  This module supplies the
two missing pieces:

  * :func:`build_cfg` — a control-flow graph for one function body:
    branches, ``while``/``for`` (including their ``else`` clauses,
    which ``break`` must bypass), ``try``/``except``/``finally`` with
    an exception edge from EVERY statement in a protected body,
    ``with`` enter/exit nodes (the exceptional exit releases the
    context manager before propagating — how a raise inside ``with
    self._lock:`` stops being "under the lock"), and
    ``return``/``raise``/``break``/``continue`` routed THROUGH
    enclosing ``finally`` blocks (each escape kind gets its own copy
    of the finally body, so ``try: return 1 finally: return 2``
    resolves the way Python resolves it).
  * :func:`fixpoint` — a forward may-analysis: abstract states are
    frozensets of tokens (locks held, spans open, files
    open-for-write), joins are unions, and a checker-supplied
    ``transfer(node, state)`` is iterated to a fixpoint.  "Token in
    the in-state" then means "held on SOME path reaching here", which
    is exactly the shape of all four new checkers' questions.

Exception model (deliberate): implicit raise edges exist only for
statements inside a ``try`` or ``with`` body (plus explicit ``raise``
anywhere).  Treating every expression in the function as potentially
raising would flag code whose cleanup idiom IS the enclosing
``try``/``finally`` — the repo's span/lock hygiene lives in those
blocks, so that is where exception paths are modeled.

Generators: a function containing ``yield`` suspends at every yield
and resumes in the same frame, so dataflow state flows straight
through yield nodes.  What must NOT happen is a nested generator
inheriting the lock-held state of its definition site (the closure
rule the flow-insensitive lock-guard uses): a generator defined under
a lock runs LATER, after the ``with`` exited — callers of
:func:`nested_function_nodes` get the definition-site state and decide
(the blocking checker zeroes it for generators).
"""

from __future__ import annotations

from typing import Callable, Dict, FrozenSet, Iterator, List, Optional, Tuple

import ast

NORMAL = "normal"
EXCEPTION = "exception"

# Finally duplication is bounded in practice (escape kinds x nesting
# depth); the cap is a backstop against pathological nesting — a
# function that blows it is skipped by its checker, never mis-analyzed.
MAX_NODES = 6000

FuncDef = (ast.FunctionDef, ast.AsyncFunctionDef)


class _TooBig(Exception):
    """Internal: node budget exceeded while building."""


def _catches_all(handler: ast.ExceptHandler) -> bool:
    """Bare ``except:`` or ``except BaseException:`` — no exception
    escapes past this handler un-dispatched."""
    if handler.type is None:
        return True
    return (isinstance(handler.type, ast.Name)
            and handler.type.id == "BaseException")


class Node:
    """One CFG node: a simple statement, a branch test, a loop test, a
    with enter/exit, a synthetic join/finally head, or one of the three
    boundary nodes (entry / exit / raise-exit)."""

    __slots__ = ("kind", "stmt", "succs", "exceptional", "is_yield",
                 "idx")

    def __init__(self, kind: str, stmt: Optional[ast.AST], idx: int,
                 exceptional: bool = False):
        self.kind = kind
        self.stmt = stmt
        self.idx = idx
        self.exceptional = exceptional
        self.is_yield = False
        self.succs: List[Tuple["Node", str]] = []

    @property
    def lineno(self) -> int:
        return getattr(self.stmt, "lineno", 0)

    def edge(self, other: "Node", kind: str = NORMAL) -> None:
        if (other, kind) not in self.succs:
            self.succs.append((other, kind))

    def __repr__(self) -> str:
        flag = "!" if self.exceptional else ""
        return f"<{self.kind}{flag}@{self.lineno}>"


class _Ctx:
    """Where control escapes to from the current build position.  The
    targets are thunks so ``finally`` copies materialize lazily (one
    per escape kind actually used)."""

    __slots__ = ("raise_to", "return_to", "break_to", "continue_to",
                 "protected")

    def __init__(self, raise_to: Callable[[], Node],
                 return_to: Callable[[], Node],
                 break_to: Optional[Callable[[], Node]],
                 continue_to: Optional[Callable[[], Node]],
                 protected: bool):
        self.raise_to = raise_to
        self.return_to = return_to
        self.break_to = break_to
        self.continue_to = continue_to
        self.protected = protected

    def replace(self, **kw) -> "_Ctx":
        vals = {s: getattr(self, s) for s in self.__slots__}
        vals.update(kw)
        return _Ctx(**vals)


class CFG:
    """The graph for one function.  ``entry`` feeds the first
    statement; ``exit`` collects every normal completion (falling off
    the end and every ``return``, after enclosing ``finally``/``with``
    exits ran); ``raise_exit`` collects exceptions that escape the
    function."""

    def __init__(self, fn):
        self.fn = fn
        self.nodes: List[Node] = []
        self.entry = self._node("entry", None)
        self.exit = self._node("exit", None)
        self.raise_exit = self._node("raise-exit", None)

    # -- construction ------------------------------------------------------

    def _node(self, kind: str, stmt: Optional[ast.AST],
              exceptional: bool = False) -> Node:
        if len(self.nodes) >= MAX_NODES:
            raise _TooBig()
        node = Node(kind, stmt, len(self.nodes), exceptional)
        self.nodes.append(node)
        return node

    def _build(self, stmts: List[ast.stmt], frontier: List[Node],
               ctx: _Ctx) -> List[Node]:
        """Wire ``stmts`` after every node in ``frontier``; return the
        new frontier (empty when all paths escaped)."""
        for stmt in stmts:
            if not frontier:
                break  # unreachable tail (after return/raise/...)
            frontier = self._build_stmt(stmt, frontier, ctx)
        return frontier

    def _connect(self, frontier: List[Node], node: Node) -> None:
        for src in frontier:
            src.edge(node)

    def _simple(self, stmt: ast.stmt, frontier: List[Node], ctx: _Ctx,
                kind: str = "stmt") -> Node:
        node = self._node(kind, stmt)
        self._connect(frontier, node)
        if ctx.protected:
            node.edge(ctx.raise_to(), EXCEPTION)
        return node

    def _build_stmt(self, stmt: ast.stmt, frontier: List[Node],
                    ctx: _Ctx) -> List[Node]:
        if isinstance(stmt, ast.If):
            test = self._simple(stmt, frontier, ctx, kind="test")
            then_f = self._build(stmt.body, [test], ctx)
            else_f = (self._build(stmt.orelse, [test], ctx)
                      if stmt.orelse else [test])
            return then_f + else_f

        if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            return self._build_loop(stmt, frontier, ctx)

        if isinstance(stmt, ast.Try) or (
                hasattr(ast, "TryStar")
                and isinstance(stmt, getattr(ast, "TryStar"))):
            return self._build_try(stmt, frontier, ctx)

        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            return self._build_with(stmt, frontier, ctx)

        if isinstance(stmt, ast.Return):
            node = self._simple(stmt, frontier, ctx)
            node.edge(ctx.return_to())
            return []

        if isinstance(stmt, ast.Raise):
            node = self._node("stmt", stmt)
            self._connect(frontier, node)
            node.edge(ctx.raise_to(), EXCEPTION)
            return []

        if isinstance(stmt, ast.Break):
            node = self._node("stmt", stmt)
            self._connect(frontier, node)
            if ctx.break_to is not None:
                node.edge(ctx.break_to())
            return []

        if isinstance(stmt, ast.Continue):
            node = self._node("stmt", stmt)
            self._connect(frontier, node)
            if ctx.continue_to is not None:
                node.edge(ctx.continue_to())
            return []

        if isinstance(stmt, FuncDef + (ast.ClassDef,)):
            # Nested definitions are single nodes; their bodies are
            # separate CFGs (see nested_function_nodes).
            node = self._simple(stmt, frontier, ctx, kind="def")
            return [node]

        # Any other statement (Expr, Assign, Assert, Import, Match,
        # ...) is one node on the normal path.
        node = self._simple(stmt, frontier, ctx)
        node.is_yield = any(
            isinstance(sub, (ast.Yield, ast.YieldFrom))
            for sub in ast.walk(stmt))
        return [node]

    def _build_loop(self, stmt, frontier: List[Node],
                    ctx: _Ctx) -> List[Node]:
        test = self._simple(stmt, frontier, ctx, kind="loop-test")
        after = self._node("join", stmt)
        body_ctx = ctx.replace(break_to=lambda: after,
                               continue_to=lambda: test)
        body_exits = self._build(stmt.body, [test], body_ctx)
        for node in body_exits:
            node.edge(test)  # back edge
        if stmt.orelse:
            # The else clause runs only when the loop exits via the
            # test going false — break jumps to `after`, bypassing it.
            else_exits = self._build(stmt.orelse, [test], ctx)
            self._connect(else_exits, after)
        else:
            test.edge(after)
        return [after]

    def _build_try(self, stmt, frontier: List[Node],
                   ctx: _Ctx) -> List[Node]:
        has_fin = bool(stmt.finalbody)

        def fin(cont: Optional[Callable[[], Node]], kind: str
                ) -> Optional[Callable[[], Node]]:
            """Route an escape kind through its own lazy copy of the
            finally body.  The copy is built with the OUTER ctx, so a
            return/raise inside the finally overrides the pending
            escape (its normal exits are what continue to ``cont``)."""
            if cont is None:
                return None
            if not has_fin:
                return cont
            cache: Dict[str, Node] = {}

            def thunk() -> Node:
                if kind not in cache:
                    head = self._node("finally", stmt,
                                      exceptional=(kind == EXCEPTION))
                    cache[kind] = head
                    exits = self._build(stmt.finalbody, [head], ctx)
                    self._connect(exits, cont())
                return cache[kind]

            return thunk

        raise_cont = fin(ctx.raise_to, EXCEPTION)
        post_ctx = ctx.replace(
            raise_to=raise_cont,
            return_to=fin(ctx.return_to, "return"),
            break_to=fin(ctx.break_to, "break"),
            continue_to=fin(ctx.continue_to, "continue"),
            protected=ctx.protected or has_fin)

        if stmt.handlers:
            dispatch = self._node("except-dispatch", stmt)
            body_raise: Callable[[], Node] = lambda: dispatch
        else:
            dispatch = None
            body_raise = post_ctx.raise_to

        body_ctx = post_ctx.replace(raise_to=body_raise,
                                    protected=True)
        body_exits = self._build(stmt.body, frontier, body_ctx)

        orelse_exits = (self._build(stmt.orelse, body_exits, post_ctx)
                        if stmt.orelse else body_exits)

        handler_exits: List[Node] = []
        if dispatch is not None:
            for handler in stmt.handlers:
                head = self._node("except", handler)
                dispatch.edge(head, EXCEPTION)
                handler_exits += self._build(handler.body, [head],
                                             post_ctx)
            if not any(_catches_all(h) for h in stmt.handlers):
                # An exception matching no handler propagates
                # outward; a bare except / except BaseException
                # swallows that edge.
                dispatch.edge(post_ctx.raise_to(), EXCEPTION)

        normal_exits = orelse_exits + handler_exits
        if not has_fin or not normal_exits:
            return normal_exits  # every path escaped: copies exist
        fhead = self._node("finally", stmt)
        self._connect(normal_exits, fhead)
        return self._build(stmt.finalbody, [fhead], ctx)

    def _build_with(self, stmt, frontier: List[Node],
                    ctx: _Ctx) -> List[Node]:
        # Two nodes for entry: "with-enter" evaluates the context
        # expressions (its exception edge carries the PRE-acquire
        # state — a raising __enter__ never held the resource), then
        # "with-acquire" is where transfer functions gen the token.
        enter = self._simple(stmt, frontier, ctx, kind="with-enter")
        acquire = self._node("with-acquire", stmt)
        enter.edge(acquire)

        def escape(cont: Optional[Callable[[], Node]],
                   exceptional: bool) -> Optional[Callable[[], Node]]:
            """Every escape from the with body runs __exit__ first: a
            lazy with-exit node releasing the managed resource, then
            the outer continuation."""
            if cont is None:
                return None
            cache: List[Node] = []

            def thunk() -> Node:
                if not cache:
                    node = self._node("with-exit", stmt,
                                      exceptional=exceptional)
                    cache.append(node)
                    node.edge(cont(),
                              EXCEPTION if exceptional else NORMAL)
                return cache[0]

            return thunk

        body_ctx = _Ctx(raise_to=escape(ctx.raise_to, True),
                        return_to=escape(ctx.return_to, False),
                        break_to=escape(ctx.break_to, False),
                        continue_to=escape(ctx.continue_to, False),
                        protected=True)
        body_exits = self._build(stmt.body, [acquire], body_ctx)
        if not body_exits:
            return []  # every path escaped through its own with-exit
        normal_exit = self._node("with-exit", stmt)
        self._connect(body_exits, normal_exit)
        return [normal_exit]

    # -- queries -----------------------------------------------------------

    def nodes_at_line(self, lineno: int) -> List[Node]:
        return [n for n in self.nodes if n.lineno == lineno]

    def edges(self) -> Iterator[Tuple[Node, Node, str]]:
        for node in self.nodes:
            for succ, kind in node.succs:
                yield node, succ, kind


def build_cfg(fn) -> Optional[CFG]:
    """CFG for one ``FunctionDef``/``AsyncFunctionDef`` body, or None
    when the node budget is exceeded (the caller skips the function —
    never analyzes a truncated graph)."""
    cfg = CFG(fn)
    base = _Ctx(raise_to=lambda: cfg.raise_exit,
                return_to=lambda: cfg.exit,
                break_to=None, continue_to=None, protected=False)
    try:
        exits = cfg._build(fn.body, [cfg.entry], base)
    except _TooBig:
        return None
    cfg._connect(exits, cfg.exit)
    return cfg


def is_generator(fn) -> bool:
    """True when the function's OWN body yields (nested defs don't
    make their parent a generator)."""
    stack: List[ast.AST] = list(fn.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.Yield, ast.YieldFrom)):
            return True
        if isinstance(node, FuncDef + (ast.Lambda,)):
            continue
        stack.extend(ast.iter_child_nodes(node))
    return False


def top_level_functions(tree: ast.Module
                        ) -> Iterator[Tuple[str, ast.AST]]:
    """(qualname, def) for module-level functions and class methods —
    the roots checkers analyze; nested defs surface through
    :func:`nested_function_nodes` with their definition-site state."""

    def walk(body, prefix):
        for node in body:
            if isinstance(node, FuncDef):
                yield f"{prefix}{node.name}", node
            elif isinstance(node, ast.ClassDef):
                yield from walk(node.body, f"{prefix}{node.name}.")

    yield from walk(tree.body, "")


def nested_function_nodes(cfg: CFG) -> Iterator[Tuple[Node, ast.AST]]:
    """(def-node, fn) for functions defined inside this CFG's function
    (one level; recursion happens through the caller re-analyzing)."""
    for node in cfg.nodes:
        if node.kind == "def" and isinstance(node.stmt, FuncDef):
            yield node, node.stmt


def node_exprs(node: Node) -> List[ast.AST]:
    """The sub-AST a checker should scan for calls AT this node: the
    whole statement for leaves, only the test/iterator for branch and
    loop heads (their bodies are separate nodes), only the context
    managers for with-enter, decorators for nested defs, nothing for
    synthetic nodes (joins, finally heads, with/except plumbing)."""
    stmt = node.stmt
    if stmt is None:
        return []
    if node.kind == "with-enter":
        return [item.context_expr for item in stmt.items]
    if node.kind == "test":
        return [stmt.test]
    if node.kind == "loop-test":
        return ([stmt.test] if isinstance(stmt, ast.While)
                else [stmt.iter])
    if node.kind == "def":
        return list(getattr(stmt, "decorator_list", []))
    if node.kind == "stmt":
        return [stmt]
    return []


def node_calls(node: Node) -> Iterator[ast.Call]:
    """Every Call expression evaluated at this node (via
    :func:`node_exprs` — never reaches into bodies of compound
    statements, which are their own nodes)."""
    for expr in node_exprs(node):
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Call):
                yield sub


def dotted(expr: ast.AST) -> Optional[str]:
    """``a.b.c`` for a pure Name/Attribute chain, else None (calls,
    subscripts, and literals in the chain make it dynamic)."""
    parts: List[str] = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if isinstance(expr, ast.Name):
        parts.append(expr.id)
        return ".".join(reversed(parts))
    return None


State = FrozenSet[object]


def fixpoint(cfg: CFG, entry_state: State,
             transfer: Callable[[Node, State], State]
             ) -> Dict[Node, State]:
    """Forward may-analysis to a fixpoint: union join, checker-supplied
    transfer.  Returns each node's IN-state (the union over all paths
    reaching it); a token present means "held/open on SOME path here".
    ``transfer`` must be monotone — gen/kill sets a function of the
    node only — which every held-state lattice here satisfies."""
    ins: Dict[Node, State] = {cfg.entry: frozenset(entry_state)}
    pending: List[Node] = [cfg.entry]
    while pending:
        node = pending.pop()
        out = transfer(node, ins.get(node, frozenset()))
        for succ, _kind in node.succs:
            cur = ins.get(succ)
            new = out if cur is None else (cur | out)
            if new != cur:
                ins[succ] = new
                pending.append(succ)
    return ins
