"""Dygraph-to-static AST conversion (a port of
``paddle_tpu/jit/dy2static.py``; reference python/paddle/fluid/dygraph/
dygraph_to_static/ ifelse_transformer.py, loop_transformer.py,
logical_transformer.py, return_transformer.py,
break_continue_transformer.py, list_transformer.py).

The AST passes are the reference's, unchanged (the port keeps its own
copy): ``_rewrite_early_returns`` (else-pushing, returns inside loops
through the break-flag carry), ``_LoopRewriter`` (``for`` loops into a
run-time choice between a while form and the plain ``for``,
``break``/``continue`` into flags and guarded remainders, ``append``
into a carried rebinding) and ``_ControlFlowTransformer`` (``if`` and
``while`` into calls of ``convert_ifelse``/``convert_while``,
``and``/``or``/``not`` into the logical helpers). The rewritten
constructs choose at run time: a Python predicate runs the plain Python
branch; a Tensor predicate goes to ``static.nn.cond`` / ``while_loop``,
which under ``jit.to_static``'s capture become CUDA conditional nodes
(one graph for every branch and trip count) and otherwise run the taken
branch eagerly.

A Tensor here is the core ``Tensor`` or a ``torch.Tensor``: the port's
GPT (``text/models.py``) returns torch tensors where the reference's
returns Tensors, and ``to_static`` takes both.

The reference's fall-backs stay, with their warnings: a function wrapped
by another decorator, source that cannot be read, a ``return <expr>``
(or a loop-local name) inside a loop, returns under ``with``/``try``.
``jit.set_code_level`` prints each converted function's source.
"""
import ast
import copy
import functools
import inspect
import textwrap
import warnings

_UNSUPPORTED = (ast.Return, ast.Break, ast.Continue, ast.Yield,
                ast.YieldFrom)


def _assigned_names(nodes):
    """Local names assigned anywhere in a list of statements (not
    descending into nested function/class scopes)."""
    names = []

    class V(ast.NodeVisitor):
        def visit_Name(self, n):
            if isinstance(n.ctx, ast.Store) and n.id not in names:
                names.append(n.id)

        def visit_AugAssign(self, n):
            if isinstance(n.target, ast.Name) and n.target.id not in names:
                names.append(n.target.id)
            self.generic_visit(n)

        def visit_FunctionDef(self, n):
            pass  # nested scope

        visit_AsyncFunctionDef = visit_Lambda = visit_ClassDef = \
            visit_FunctionDef

    for s in nodes:
        V().visit(s)
    return names


def _contains_unsupported(nodes):
    """Return/break/... at THIS scope level. Does not descend into
    nested function definitions: a `return` inside a helper generated by
    an earlier if/while conversion belongs to that helper's scope, not
    to the statement list being checked."""
    todo = list(nodes)
    while todo:
        s = todo.pop()
        if isinstance(s, _UNSUPPORTED):
            return True
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda, ast.ClassDef)):
            continue
        todo.extend(ast.iter_child_nodes(s))
    return False


def _level_stmts(nodes):
    """Statements at a loop's own nesting level: walk into If bodies but
    NOT into nested loops / function defs (their break/continue belong
    to them)."""
    for s in nodes:
        yield s
        if isinstance(s, ast.If):
            yield from _level_stmts(s.body)
            yield from _level_stmts(s.orelse)


def _own_break_continue(body):
    has_b = has_c = hard = False
    for s in _level_stmts(body):
        if isinstance(s, ast.Break):
            has_b = True
        elif isinstance(s, ast.Continue):
            has_c = True
        elif isinstance(s, (ast.Return, ast.Yield, ast.YieldFrom)):
            hard = True
        elif isinstance(s, (ast.With, ast.Try)):
            # we can't guard statements inside with/try: bail if they
            # hide break/continue
            for sub in ast.walk(s):
                if isinstance(sub, (ast.Break, ast.Continue)):
                    hard = True
    return has_b, has_c, hard


def _name(n, ctx=ast.Load):
    return ast.Name(id=n, ctx=ctx())


def _assign(name, value):
    return ast.Assign(targets=[_name(name, ast.Store)], value=value)


def _call(fname, *args):
    return ast.Call(func=_name(fname), args=list(args), keywords=[])


class _GiveUpReturns(Exception):
    """Raised when an early-return shape needs run-time flag guarding
    (maybe-returning branch legs, returns under loops/with/try) — the
    function keeps its original return statements and the existing
    python-semantics fallback handles them."""


def _returns_anywhere(nodes):
    """Any Return in the subtree, not descending into nested scopes."""
    todo = list(nodes)
    while todo:
        s = todo.pop()
        if isinstance(s, ast.Return):
            return True
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda, ast.ClassDef)):
            continue
        todo.extend(ast.iter_child_nodes(s))
    return False


def _leg_class(stmts):
    """Classify a statement list: 'A' = every path returns, 'N' = no
    path returns, 'M' = some paths return (needs flags; unsupported)."""
    for idx, s in enumerate(stmts):
        if isinstance(s, ast.Return):
            return "A"
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            continue
        if isinstance(s, ast.If):
            b, o = _leg_class(s.body), _leg_class(s.orelse)
            if "M" in (b, o):
                return "M"
            if b == "A" and o == "A":
                return "A"
            if "A" in (b, o):
                return "A" if _leg_class(stmts[idx + 1:]) == "A" else "M"
            continue
        if _returns_anywhere([s]):
            return "M"  # return under a loop / with / try
    return "N"


def _rewrite_returns(stmts, ret):
    """Else-push restructuring: every `return v` becomes `ret = v`, and
    statements following an if whose one leg always returns move into
    the other leg — so after the rewrite every return-path is an
    assignment and control flow is plain nested ifs (which the later
    passes lower to cond under Tensor predicates). Raises
    _GiveUpReturns on the flag-needing shapes."""
    out = []
    for idx, s in enumerate(stmts):
        if isinstance(s, ast.Return):
            out.append(_assign(
                ret, s.value if s.value is not None
                else ast.Constant(value=None)))
            return out  # rest of the block is unreachable
        if isinstance(s, ast.If) and _returns_anywhere([s]):
            b, o = _leg_class(s.body), _leg_class(s.orelse)
            if "M" in (b, o) or (b, o) == ("N", "N"):
                raise _GiveUpReturns()
            body = _rewrite_returns(list(s.body), ret)
            orelse = _rewrite_returns(list(s.orelse), ret)
            if b == "A" and o == "A":
                out.append(ast.If(test=s.test, body=body, orelse=orelse))
                return out  # rest unreachable: both legs returned
            rest = _rewrite_returns(list(stmts[idx + 1:]), ret)
            if b == "A":
                out.append(ast.If(test=s.test, body=body,
                                  orelse=orelse + rest))
            else:  # o == "A"
                out.append(ast.If(test=s.test, body=body + rest,
                                  orelse=orelse))
            return out
        if _returns_anywhere([s]) and not isinstance(
                s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            raise _GiveUpReturns()
        out.append(s)
    return out


def _loop_direct_return_name(loop):
    """The single bare-Name id that EVERY Return directly inside this
    loop's body returns (not descending into nested loops / scopes /
    with / try), or '' when the body has no direct returns. Raises
    _GiveUpReturns when returns exist but are not all `return <same
    name>` — those shapes keep the python fallback."""
    rets = []

    def walk(block):
        for s in block:
            if isinstance(s, (ast.For, ast.While, ast.FunctionDef,
                              ast.AsyncFunctionDef, ast.ClassDef,
                              ast.With, ast.Try)):
                continue  # nested loops already converted; with/try
                # with returns raise in the caller's traversal
            if isinstance(s, ast.Return):
                rets.append(s)
            elif isinstance(s, ast.If):
                # If is the only compound statement left that can nest
                # a direct return
                walk(s.body)
                walk(s.orelse)

    walk(loop.body)
    if not rets:
        return ""
    names = {r.value.id if isinstance(r.value, ast.Name) else None
             for r in rets}
    if len(names) != 1 or None in names:
        raise _GiveUpReturns()
    return names.pop()


def _replace_loop_returns(block, flag):
    """Replace every direct `return <name>` in the block with
    `<flag> = True; break` (same traversal scope as
    _loop_direct_return_name)."""
    out = []
    for s in block:
        if isinstance(s, ast.Return):
            out.append(_assign(flag, ast.Constant(value=True)))
            out.append(ast.Break())
            continue  # anything after is unreachable
        if isinstance(s, ast.If):
            s.body = _replace_loop_returns(s.body, flag)
            s.orelse = _replace_loop_returns(s.orelse, flag)
        out.append(s)
    return out


def _rewrite_loop_returns(block, counter, bound):
    """Pre-pass for returns INSIDE loops (the flag-needing shape the
    else-push can't express): `return x` in a loop body becomes
    `__jst_retflagN = True` + `break` — the loop machinery already
    carries break flags through while_loop, so the compiled loop
    exits early — and `if __jst_retflagN: return x` is inserted right
    after the loop, which the else-push pass then merges. Restricted to
    `return <bare name>` where the name is BOUND BEFORE the loop (the
    returned value rides the loop's own carry, so the conversion
    introduces no new typed carry — loop carries must be type-stable and
    a name first assigned inside the loop has no pre-loop init; `bound`
    threads the names assigned so far, seeded with the function args).
    Bottom-up, so nested loops cascade: an inner loop's post-loop
    return is the outer loop's direct return."""
    changed = False
    out = []
    for s in block:
        if isinstance(s, (ast.With, ast.Try)) and _returns_anywhere([s]):
            raise _GiveUpReturns()
        if isinstance(s, ast.If):
            pre = set(bound)
            s.body, c1 = _rewrite_loop_returns(s.body, counter,
                                               set(pre))
            s.orelse, c2 = _rewrite_loop_returns(s.orelse, counter,
                                                 set(pre))
            changed = changed or c1 or c2
            out.append(s)
            bound.update(_assigned_names([s]))
            continue
        if isinstance(s, (ast.For, ast.While)):
            inner = set(bound)
            if isinstance(s, ast.For):
                inner.update(_assigned_names([ast.Assign(
                    targets=[s.target], value=ast.Constant(value=0))]))
            s.body, c1 = _rewrite_loop_returns(s.body, counter, inner)
            s.orelse, c2 = _rewrite_loop_returns(s.orelse, counter,
                                                 set(bound))
            changed = changed or c1 or c2
            name = _loop_direct_return_name(s)
            if name:
                if name not in bound:
                    # a name first assigned inside the loop would become
                    # a fresh init-less carry under a Tensor bound —
                    # keep the python fallback for that shape
                    raise _GiveUpReturns()
                counter[0] += 1
                flag = f"__jst_retflag{counter[0]}"
                s.body = _replace_loop_returns(s.body, flag)
                out.append(_assign(flag, ast.Constant(value=False)))
                out.append(s)
                out.append(ast.If(test=_name(flag),
                                  body=[ast.Return(value=_name(name))],
                                  orelse=[]))
                changed = True
                bound.update(_assigned_names([s]))
                continue
        out.append(s)
        bound.update(_assigned_names([s]))
    return out, changed


def _rewrite_early_returns(fdef):
    """Apply the else-push return rewrite to a function body when it has
    early returns. Returns True when the body was rewritten."""
    early = any(_returns_anywhere([s]) for s in fdef.body
                if not isinstance(s, ast.Return))
    if not early:
        return False
    ret = "__jst_retval"
    try:
        # operate on a copy: a giveup mid-way must leave the original
        # body untouched for the python fallback
        body = copy.deepcopy(fdef.body)
        a = fdef.args
        args = {x.arg for x in (a.posonlyargs + a.args + a.kwonlyargs)}
        for va in (a.vararg, a.kwarg):
            if va is not None:
                args.add(va.arg)
        body, _ = _rewrite_loop_returns(body, [0], args)
        new_body = _rewrite_returns(body, ret)
    except _GiveUpReturns:
        warnings.warn(
            f"dy2static: {fdef.name} has a return whose execution is "
            "conditional inside a with/try, a partially-returning "
            "branch, or a loop-return shape beyond `return <name>`; "
            "early-return conversion skipped (a Tensor predicate there "
            "keeps python semantics)")
        return False
    fdef.body = ([_assign(ret, ast.Constant(value=None))] + new_body
                 + [ast.Return(value=_name(ret))])
    return True


class _LoopRewriter(ast.NodeTransformer):
    """First pass (reference: LoopTransformer + BreakContinueTransformer
    + ListTransformer). Rewrites `for` loops into a runtime dispatch
    between a while-form (Tensor bounds/seq -> single while_loop
    program) and the plain python form, and rewrites break/continue in
    for/while bodies into flag variables with guarded remainders. The
    second pass (_ControlFlowTransformer) then lowers the generated
    while/if/boolop nodes exactly like hand-written ones."""

    def __init__(self):
        self.counter = 0
        self.changed = False

    def _fresh(self, base):
        self.counter += 1
        return f"__jst_{base}{self.counter}"

    # -- list ops: lst.append(x) -> lst = __jst_list_append(lst, x) ------
    def _rewrite_appends(self, stmts):
        out = []
        for s in stmts:
            call = s.value if isinstance(s, ast.Expr) else None
            if (isinstance(call, ast.Call)
                    and isinstance(call.func, ast.Attribute)
                    and call.func.attr == "append"
                    and isinstance(call.func.value, ast.Name)
                    and len(call.args) == 1 and not call.keywords):
                lst = call.func.value.id
                out.append(_assign(lst, _call("__jst_list_append",
                                              _name(lst),
                                              call.args[0])))
                self.changed = True
            elif isinstance(s, ast.If):
                s.body = self._rewrite_appends(s.body)
                s.orelse = self._rewrite_appends(s.orelse)
                out.append(s)
            else:
                out.append(s)
        return out

    # -- break/continue -> flags + guarded remainders --------------------
    def _rewrite_bc(self, stmts, bn, cn):
        """Replace break/continue with flag sets; everything after a
        statement that may set a flag moves under `if not (bn or cn)`.
        Returns the new statement list."""
        out = []
        for idx, s in enumerate(stmts):
            if isinstance(s, ast.Break):
                out.append(_assign(bn, ast.Constant(value=True)))
                return out  # rest of the block is dead code
            if isinstance(s, ast.Continue):
                out.append(_assign(cn, ast.Constant(value=True)))
                return out
            if isinstance(s, ast.If):
                sb, sc, _ = _own_break_continue([s])
                if sb or sc:
                    s.body = self._rewrite_bc(s.body, bn, cn)
                    s.orelse = self._rewrite_bc(s.orelse, bn, cn)
                    out.append(s)
                    rest = self._rewrite_bc(stmts[idx + 1:], bn, cn)
                    if rest:
                        # guard the remainder on exactly the flags this
                        # If may have set
                        flags = ([_name(bn)] if sb else []) \
                            + ([_name(cn)] if sc else [])
                        test = ast.UnaryOp(
                            op=ast.Not(),
                            operand=(flags[0] if len(flags) == 1 else
                                     ast.BoolOp(op=ast.Or(),
                                                values=flags)))
                        out.append(ast.If(test=test, body=rest,
                                          orelse=[]))
                    return out
            out.append(s)
        return out

    # -- while: only break/continue handling (tensor conds are handled
    #    by the second pass) --------------------------------------------
    def visit_While(self, node):
        self.generic_visit(node)
        if node.orelse:
            return node
        has_b, has_c, hard = _own_break_continue(node.body)
        if hard:
            return node
        # appends are rewritten even without break/continue: a raw
        # .append surviving into a Tensor-lowered body would append ONE
        # trace-time tracer to a closure list instead of failing loudly
        node.body = self._rewrite_appends(list(node.body))
        if not (has_b or has_c):
            return node
        self.changed = True
        bn = self._fresh("brk")
        cn = self._fresh("cont")
        body = self._rewrite_bc(node.body, bn, cn)
        if has_c:
            body = [_assign(cn, ast.Constant(value=False))] + body
        # break folds into the condition: `flag_ok(bn) and (cond)`.
        # Python flag -> python bool (early exit); Tensor flag (a
        # converted tensor-pred break) -> the whole condition turns
        # Tensor and the second pass lowers the loop to while_loop.
        test = ast.BoolOp(op=ast.And(),
                          values=[_call("__jst_flag_ok", _name(bn)),
                                  node.test])
        new = ast.While(test=test, body=body, orelse=[])
        return [_assign(bn, ast.Constant(value=False)),
                _assign(cn, ast.Constant(value=False)), new]

    # -- for -------------------------------------------------------------
    def visit_For(self, node):
        self.generic_visit(node)
        if node.orelse or not isinstance(node.target, ast.Name):
            return node
        has_b, has_c, hard = _own_break_continue(node.body)
        if hard:
            return node
        is_range = (isinstance(node.iter, ast.Call)
                    and isinstance(node.iter.func, ast.Name)
                    and node.iter.func.id == "range"
                    and 1 <= len(node.iter.args) <= 3
                    and not node.iter.keywords)
        t = node.target.id
        self.changed = True
        bn = self._fresh("brk")
        cn = self._fresh("cont")
        iv = self._fresh("i")
        pre = [_assign(bn, ast.Constant(value=False)),
               _assign(cn, ast.Constant(value=False))]

        if is_range:
            sn, en, stn = (self._fresh("start"), self._fresh("stop"),
                           self._fresh("step"))
            pre.append(ast.Assign(
                targets=[ast.Tuple(elts=[_name(sn, ast.Store),
                                         _name(en, ast.Store),
                                         _name(stn, ast.Store)],
                                   ctx=ast.Store())],
                value=_call("__jst_range3", *node.iter.args)))
            dispatch_test = _call("__jst_any_tensor", _name(sn),
                                  _name(en), _name(stn))
            # init the target too: it must be a VALID while_loop
            # carry (an _UNDEF placeholder can't enter the traced init)
            w_init = [_assign(iv, _name(sn)), _assign(t, _name(sn))]
            w_cond = _call("__jst_range_cond", _name(iv), _name(en),
                           _name(stn))
            w_elem = _assign(t, _name(iv))
            w_step = _assign(iv, ast.BinOp(left=_name(iv), op=ast.Add(),
                                           right=_name(stn)))
            py_iter = _call("range", _name(sn), _name(en), _name(stn))
        else:
            qn = self._fresh("seq")
            pre.append(_assign(qn, node.iter))
            dispatch_test = _call("__jst_any_tensor", _name(qn))
            w_init = [_assign(iv, _call("__jst_index0")),
                      _assign(t, _call("__jst_first_elem", _name(qn)))]
            w_cond = ast.Compare(left=_name(iv), ops=[ast.Lt()],
                                 comparators=[_call("__jst_seq_len",
                                                    _name(qn))])
            w_elem = _assign(t, _call("__jst_dyn_index", _name(qn),
                                      _name(iv)))
            w_step = _assign(iv, ast.BinOp(left=_name(iv), op=ast.Add(),
                                           right=ast.Constant(value=1)))
            py_iter = _name(qn)

        # tensor branch: while-form (ONE traced program). The element
        # read and the body run under the continue/break guards the
        # rewriter inserts; the index increment stays unconditional.
        tb = self._rewrite_appends(copy.deepcopy(list(node.body)))
        tb = self._rewrite_bc([w_elem] + tb, bn, cn)
        if has_c:
            tb = [_assign(cn, ast.Constant(value=False))] + tb
        w_test = ast.BoolOp(op=ast.And(),
                            values=[_call("__jst_flag_ok", _name(bn)),
                                    w_cond])
        tensor_branch = w_init + [ast.While(test=w_test, body=tb
                                            + [w_step], orelse=[])]

        # python branch: plain for (trace-unrolled, python semantics);
        # break/continue become the same flags + guards, with a REAL
        # `break` when the flag is python-True (early exit preserved)
        pb = self._rewrite_appends(copy.deepcopy(list(node.body)))
        if has_b or has_c:
            pb = self._rewrite_bc(pb, bn, cn)
            if has_c:
                pb = [_assign(cn, ast.Constant(value=False))] + pb
            if has_b:
                # a TENSOR break flag can't python-break: every later
                # iteration must be FULLY masked, including statements
                # before the break check — so the whole body goes under
                # `if not bn` (python flag: plain if; tensor flag: the
                # second pass lowers it to cond). The python early
                # exit checks the flag at the END of the iteration that
                # set it: a top-of-next-iteration check would run the
                # loop header once more, leaking the loop variable one
                # step past the break and consuming an extra iterator
                # element.
                pb = [ast.If(test=ast.UnaryOp(op=ast.Not(),
                                              operand=_name(bn)),
                             body=pb, orelse=[]),
                      ast.If(test=_call("__jst_is_py_true", _name(bn)),
                             body=[ast.Break()], orelse=[])]
        py_branch = [ast.For(target=ast.Name(id=t, ctx=ast.Store()),
                             iter=py_iter, body=pb, orelse=[])]

        return pre + [ast.If(test=dispatch_test, body=tensor_branch,
                             orelse=py_branch)]


class _ControlFlowTransformer(ast.NodeTransformer):
    """Rewrites if/while statements into runtime-dispatch helper calls."""

    def __init__(self):
        self.counter = 0
        self.failed = False

    def _fresh(self, base):
        self.counter += 1
        return f"__jst_{base}_{self.counter}"

    # -- if/elif/else ------------------------------------------------------
    def visit_If(self, node):
        self.generic_visit(node)
        if self.failed:
            return node
        if _contains_unsupported(node.body) or \
                _contains_unsupported(node.orelse):
            # branches with return/break/... keep python semantics; a
            # tensor predicate there raises at runtime via __bool__
            return node
        body_names = set(_assigned_names(node.body))
        orelse_names = set(_assigned_names(node.orelse))
        out_names = sorted(body_names | orelse_names)
        # names assigned in only ONE branch: when also unbound before
        # the if, they cannot be a cond output (the other branch
        # has no value to produce) — convert_ifelse drops them from
        # the cond and rebinds _Undefined, matching python's
        # maybe-unbound semantics (read later -> UnboundLocalError).
        # The else-push return rewrite routinely creates this shape:
        # remainder temporaries live only inside the pushed leg.
        maybe_names = sorted(body_names ^ orelse_names)
        if not out_names:
            return node
        true_name = self._fresh("true_fn")
        false_name = self._fresh("false_fn")
        ret = ast.Return(value=ast.Tuple(
            elts=[ast.Name(id=n, ctx=ast.Load()) for n in out_names],
            ctx=ast.Load()))

        def make_fn(name, body):
            # PURE branches: current values of out_names come in as
            # parameters (same names, so `y = y * 10` reads the pre-if
            # value) and updates go out via the return. No nonlocal —
            # writes must not leak between cond's two branch traces.
            fargs = ast.arguments(
                posonlyargs=[],
                args=[ast.arg(arg=n) for n in out_names],
                kwonlyargs=[], kw_defaults=[], defaults=[])
            return ast.FunctionDef(
                name=name, args=fargs,
                body=(list(body) if body else [ast.Pass()]) + [ret],
                decorator_list=[], type_params=[])

        call = ast.Assign(
            targets=[ast.Tuple(
                elts=[ast.Name(id=n, ctx=ast.Store()) for n in out_names],
                ctx=ast.Store())],
            value=ast.Call(
                func=ast.Name(id="__jst_convert_ifelse", ctx=ast.Load()),
                args=[node.test,
                      ast.Name(id=true_name, ctx=ast.Load()),
                      ast.Name(id=false_name, ctx=ast.Load()),
                      ast.Tuple(elts=[ast.Constant(value=n)
                                      for n in out_names],
                                ctx=ast.Load()),
                      ast.Tuple(elts=[ast.Constant(value=n)
                                      for n in maybe_names],
                                ctx=ast.Load()),
                      ast.Call(func=ast.Name(id="locals", ctx=ast.Load()),
                               args=[], keywords=[])],
                keywords=[]))
        return [make_fn(true_name, node.body),
                make_fn(false_name, node.orelse), call]

    # -- while -------------------------------------------------------------
    def visit_While(self, node):
        self.generic_visit(node)
        if self.failed or node.orelse or _contains_unsupported(node.body):
            return node
        # carry EVERY assigned name: a store-only variable's last value
        # must survive the loop too
        carried = sorted(set(_assigned_names(node.body)))
        if not carried:
            return node
        args = ast.arguments(
            posonlyargs=[],
            args=[ast.arg(arg=n) for n in carried],
            kwonlyargs=[], kw_defaults=[], defaults=[])
        ret = ast.Return(value=ast.Tuple(
            elts=[ast.Name(id=n, ctx=ast.Load()) for n in carried],
            ctx=ast.Load()))
        cond_name = self._fresh("while_cond")
        body_name = self._fresh("while_body")
        cond_fn = ast.FunctionDef(
            name=cond_name, args=args,
            body=[ast.Return(value=node.test)], decorator_list=[],
            type_params=[])
        body_fn = ast.FunctionDef(
            name=body_name, args=args,
            body=list(node.body) + [ret], decorator_list=[], type_params=[])
        call = ast.Assign(
            targets=[ast.Tuple(
                elts=[ast.Name(id=n, ctx=ast.Store()) for n in carried],
                ctx=ast.Store())],
            value=ast.Call(
                func=ast.Name(id="__jst_convert_while", ctx=ast.Load()),
                args=[ast.Name(id=cond_name, ctx=ast.Load()),
                      ast.Name(id=body_name, ctx=ast.Load()),
                      ast.Tuple(elts=[ast.Constant(value=n)
                                      for n in carried], ctx=ast.Load()),
                      ast.Call(func=ast.Name(id="locals", ctx=ast.Load()),
                               args=[], keywords=[])],
                keywords=[]))
        return [cond_fn, body_fn, call]

    # -- and/or/not over tensors ------------------------------------------
    def visit_BoolOp(self, node):
        self.generic_visit(node)
        name = ("__jst_and" if isinstance(node.op, ast.And) else "__jst_or")
        self.counter += 1
        empty_args = ast.arguments(posonlyargs=[], args=[], kwonlyargs=[],
                                   kw_defaults=[], defaults=[])
        out = node.values[0]
        for v in node.values[1:]:
            # rhs wrapped in a lambda: python short-circuit semantics are
            # preserved for non-tensor operands (reference:
            # logical_transformer.py does the same)
            out = ast.Call(func=ast.Name(id=name, ctx=ast.Load()),
                           args=[out, ast.Lambda(args=empty_args, body=v)],
                           keywords=[])
        return out

    def visit_UnaryOp(self, node):
        self.generic_visit(node)
        if isinstance(node.op, ast.Not):
            self.counter += 1
            return ast.Call(func=ast.Name(id="__jst_not", ctx=ast.Load()),
                            args=[node.operand], keywords=[])
        return node


# -- runtime helpers --------------------------------------------------------

def _is_tensor(x):
    import torch

    from ..core.tensor import Tensor
    return isinstance(x, (Tensor, torch.Tensor))


class _Undefined:
    """Placeholder for an out_name not yet bound before the if statement.
    Any USE raises, matching python's UnboundLocalError for a variable the
    taken branch never assigned; assign-then-use inside a branch is fine
    (the parameter is simply overwritten)."""

    def __init__(self, name=None):
        object.__setattr__(self, "_jst_name", name)

    def _raise(self, *a, **k):
        name = object.__getattribute__(self, "_jst_name")
        label = f"variable {name!r}" if name else "local variable"
        raise UnboundLocalError(
            f"{label} referenced before assignment in to_static "
            "converted control flow. If it carries a value ACROSS "
            "iterations of a Tensor-bounded loop (assigned on one "
            "iteration, read on the next), initialize it before the "
            "loop — while_loop needs a concrete entry value for "
            "every carried variable.")

    __bool__ = __iter__ = __call__ = __len__ = _raise
    __add__ = __radd__ = __sub__ = __rsub__ = __mul__ = __rmul__ = _raise
    __truediv__ = __rtruediv__ = __getitem__ = __eq__ = __lt__ = _raise

    def __getattr__(self, name):
        self._raise()

    def __repr__(self):
        return "<undefined local>"


_UNDEF = _Undefined()


def convert_ifelse(pred, true_fn, false_fn, out_names, maybe_names,
                   local_ns):
    """Runtime dispatch (reference: dygraph_to_static convert_ifelse).
    Python predicate -> plain python branch. Tensor predicate -> cond
    via static.nn; both branches are pure functions of the current
    out_name values and must produce every output.

    maybe_names: out_names assigned in only ONE branch. When such a name
    is also unbound before the if, it is excluded from the cond outputs
    (the other branch has no value for it) and rebinds _Undefined —
    python's maybe-unbound semantics: dead afterwards is fine, a later
    read raises UnboundLocalError."""
    args = [local_ns.get(n, _Undefined(n)) for n in out_names]
    if not _is_tensor(pred):
        return true_fn(*args) if pred else false_fn(*args)
    from ..static import nn as snn
    maybe = set(maybe_names)
    inc = [i for i, n in enumerate(out_names)
           if n not in maybe or not isinstance(args[i], _Undefined)]

    if not inc:
        # no observable output survives (every name maybe-assigned and
        # unbound-incoming): the pure branches have no effect to keep
        return tuple(_Undefined(n) for n in out_names)

    def _narrow(fn):
        def run():
            full = fn(*args)
            return tuple(full[i] for i in inc)
        return run

    try:
        outs = snn.cond(pred, _narrow(true_fn), _narrow(false_fn))
    except TypeError as e:
        # an <undefined local> placeholder reached jnp.asarray: a branch
        # read or returned an out_name it never assigned
        if "_Undefined" in str(e) or "undefined local" in str(e):
            raise RuntimeError(
                "to_static if/else on a Tensor predicate: every converted "
                f"output {list(out_names)} must be assigned in BOTH "
                "branches or defined before the if statement") from e
        raise
    outs = outs if isinstance(outs, tuple) else (outs,)
    full = [_Undefined(n) for n in out_names]
    for i, v in zip(inc, outs):
        full[i] = v
    # call site always tuple-unpacks the out_names
    return tuple(full)


def convert_while(cond_fn, body_fn, out_names, local_ns):
    """Runtime dispatch for while loops: python condition -> plain loop;
    Tensor condition -> while_loop via static.nn.

    Names assigned in the body but UNDEFINED at loop entry (pure body
    temporaries) can't enter the loop carry — they are dropped from the
    loop state and live as per-iteration locals instead (the reference's
    loop_transformer does the same via liveness analysis). Reading such
    a temporary after a Tensor loop — or carrying one ACROSS iterations
    — raises UnboundLocalError naming the variable (initialize it before
    the loop), matching python's behavior for a zero-trip loop."""
    carried = tuple(local_ns.get(n, _Undefined(n)) for n in out_names)
    first = cond_fn(*carried)
    if not _is_tensor(first):
        vals = carried
        while True:
            c = cond_fn(*vals)
            if _is_tensor(c):
                from ..core import trace as trace_mod
                if trace_mod.current_trace() is not None:
                    # the condition turned Tensor mid-unroll (a python
                    # counter met a Tensor break flag): hand the REST of
                    # the loop to while_loop from the current state
                    # — iterations so far stay unrolled, the remainder
                    # compiles as one traced loop
                    return _tensor_while(cond_fn, body_fn, vals)
                c = bool(_host_item(c))  # eager: the value is at hand
            if not c:
                break
            out = body_fn(*vals)
            vals = out if isinstance(out, tuple) else (out,)
        return vals
    return _tensor_while(cond_fn, body_fn, carried)


def _tensor_while(cond_fn, body_fn, carried):
    """while_loop leg of convert_while (entry-undefined names are
    dropped to per-iteration locals; see convert_while docstring)."""
    from ..static import nn as snn

    def _friendly_structure_error(e):
        msg = str(e)
        if "structure" in msg or "pytree" in msg or "tree" in msg:
            return TypeError(
                "to_static Tensor-bounded loop: the loop state changed "
                "structure between iterations (e.g. a list grew via "
                "append). Loop carries need static shapes — "
                "preallocate a buffer (paddle.zeros) and write with "
                "paddle.scatter instead. Original error: " + msg)
        return None

    live = [i for i, v in enumerate(carried)
            if not isinstance(v, _Undefined)]
    if len(live) == len(carried):
        try:
            out = snn.while_loop(cond_fn, lambda *a: body_fn(*a),
                                 list(carried))
        except (TypeError, ValueError) as e:
            fe = _friendly_structure_error(e)
            if fe is not None:
                raise fe from e
            raise
        return tuple(out)

    def _full(live_vals):
        vals = list(carried)
        for i, v in zip(live, live_vals):
            vals[i] = v
        return vals

    def _body_live(*lv):
        r = body_fn(*_full(lv))
        r = r if isinstance(r, tuple) else (r,)
        return tuple(r[i] for i in live)

    try:
        out = snn.while_loop(lambda *lv: cond_fn(*_full(lv)), _body_live,
                             [carried[i] for i in live])
    except (TypeError, ValueError) as e:
        fe = _friendly_structure_error(e)
        if fe is not None:
            raise fe from e
        raise
    vals = list(carried)
    for i, v in zip(live, out):
        vals[i] = v
    return tuple(vals)


def _host_item(t):
    """A one-element Tensor's (or torch tensor's) value on the host."""
    from ..core.tensor import Tensor
    v = t._value if isinstance(t, Tensor) else t
    return v.reshape(()).item()


def convert_logical_and(a, b_fn):
    """b_fn is lazy: python short-circuit is preserved for non-tensors."""
    if _is_tensor(a):
        from ..ops import logic
        b = b_fn()
        return logic.logical_and(a, b)
    if not a:
        return a
    b = b_fn()
    if _is_tensor(b):
        from ..ops import logic
        return logic.logical_and(a, b)
    return b


def convert_logical_or(a, b_fn):
    if _is_tensor(a):
        from ..ops import logic
        return logic.logical_or(a, b_fn())
    if a:
        return a
    b = b_fn()
    if _is_tensor(b):
        from ..ops import logic
        return logic.logical_or(a, b)
    return b


def convert_logical_not(a):
    if _is_tensor(a):
        from ..ops import logic
        return logic.logical_not(a)
    return not a


# -- loop-family runtime helpers (reference: loop_transformer.py) -----------

def loop_range3(*args):
    """Normalize range(...) arguments to (start, stop, step),
    Tensor-transparent."""
    if len(args) == 1:
        return 0, args[0], 1
    if len(args) == 2:
        return args[0], args[1], 1
    return args


def loop_any_tensor(*xs):
    return any(_is_tensor(x) for x in xs)


def loop_range_cond(i, stop, step):
    """`i` still in range for a (possibly Tensor) start/stop/step."""
    if not (_is_tensor(i) or _is_tensor(stop) or _is_tensor(step)):
        return i < stop if step > 0 else i > stop
    from ..ops import logic
    if not _is_tensor(step):  # static step: direction known at trace
        return i < stop if step > 0 else i > stop
    return logic.logical_or(
        logic.logical_and(step > 0, i < stop),
        logic.logical_and(step < 0, i > stop))


def loop_flag_ok(flag):
    """Loop-condition term for the break flag: keep looping while the
    flag is unset. Python flag -> python bool (preserves early exit);
    Tensor flag -> the whole condition turns Tensor and the loop lowers
    to while_loop."""
    if _is_tensor(flag):
        from ..ops import logic
        return logic.logical_not(flag)
    return not flag


def loop_is_py_true(flag):
    """True only for a PYTHON True flag — drives the real `break` in the
    unrolled python branch; Tensor flags are handled by the guards."""
    return flag is True


def loop_index0():
    """A 0-d int64 zero on the current device (made by a fill, which a
    capture can hold; ``to_tensor`` would copy from the host)."""
    import torch

    from ..core import device as device_mod
    from ..core.tensor import Tensor
    return Tensor._wrap(torch.zeros((), dtype=torch.int64,
                                    device=device_mod.resolve_device()))


def loop_seq_len(seq):
    if _is_tensor(seq):
        return int(seq.shape[0])  # static leading dim
    return len(seq)


def loop_dyn_index(seq, i):
    """seq[i] with a (possibly traced) scalar Tensor index."""
    if not _is_tensor(seq):
        idx = int(_host_item(i)) if _is_tensor(i) else i
        return seq[idx]
    from ..ops import manipulation
    row = manipulation.gather(seq, manipulation.reshape(i, [1]))
    return manipulation.squeeze(row, axis=0)



def loop_first_elem(seq):
    """Valid loop-carry init for the loop target: first element, or a
    zero element for an empty seq (python: the name would stay unbound
    after a zero-trip loop — reading it then is an error either way)."""
    if not _is_tensor(seq):
        return seq[0] if len(seq) else _UNDEF
    if seq.shape[0] > 0:
        return seq[0]
    import torch

    from ..core.tensor import Tensor
    v = seq._value if isinstance(seq, Tensor) else seq
    return Tensor._wrap(torch.zeros(v.shape[1:], dtype=v.dtype,
                                    device=v.device))


def convert_list_append(lst, x):
    """`lst.append(x)` rewritten as a carried rebinding. Python lists
    keep python semantics; appending under a Tensor trip count cannot
    work under static shapes (reference executes LoDTensorArray
    growth in its interpreter) — preallocate + scatter instead."""
    if isinstance(lst, list):
        return lst + [x]
    if isinstance(lst, _Undefined):
        raise UnboundLocalError(
            "append target referenced before assignment in a converted "
            "loop")
    raise TypeError(
        f"to_static list append target is {type(lst).__name__}, not a "
        "list. Appending under a Tensor trip count is impossible with "
        "static shapes — preallocate a buffer (paddle.zeros) and "
        "write with paddle.scatter, or keep the loop bound a python "
        "int")


# jit.set_code_level: above 0, each converted function's source is
# printed
_code_level = [0]


def converted_ast(fn):
    """The module AST ``convert_to_static`` compiles for ``fn`` (None
    when it does not convert): the three passes' output, before
    ``fix_missing_locations``."""
    src = textwrap.dedent(inspect.getsource(fn))
    tree = ast.parse(src)
    fdef = tree.body[0]
    if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return None  # a lambda's line: an expression, nothing to convert
    fdef.decorator_list = []
    ret_changed = _rewrite_early_returns(fdef)
    lr = _LoopRewriter()
    tree = lr.visit(tree)
    tr = _ControlFlowTransformer()
    new_tree = tr.visit(tree)
    if tr.failed or (tr.counter == 0 and not lr.changed
                     and not ret_changed):
        return None
    return new_tree


class _GlobalsProxy(dict):
    """exec globals that fall back to the original module globals — late-
    bound helpers and recursion resolve at call time like undecorated
    python."""

    def __init__(self, base, extra):
        super().__init__(extra)
        self._base = base

    def __missing__(self, key):
        return self._base[key]


def convert_to_static(fn):
    """AST-rewrite fn's control flow; returns the original fn when the
    source is unavailable or the rewrite does not apply."""
    import types
    if inspect.ismethod(fn):
        inner = convert_to_static(fn.__func__)
        if inner is fn.__func__:
            return fn
        return types.MethodType(inner, fn.__self__)
    if getattr(fn, "__wrapped__", None) is not None \
            and getattr(fn, "__code__", None) is not \
            getattr(inspect.unwrap(fn), "__code__", None):
        # fn is a decorator wrapper around the real function —
        # inspect.getsource would return the INNER source and re-execing
        # it would silently drop the wrapper; keep Python semantics instead
        warnings.warn(
            f"dy2static: {fn.__name__} is wrapped by another decorator; "
            "skipping AST conversion (tensor-dependent python control "
            "flow keeps Python semantics: a Tensor if raises under "
            "capture)")
        return fn
    try:
        new_tree = converted_ast(fn)
        if new_tree is None:
            return fn  # nothing rewritten
        ast.fix_missing_locations(new_tree)
        if _code_level[0] > 0:
            print(f"dy2static: {fn.__qualname__} converted:\n"
                  f"{ast.unparse(new_tree)}")
        # the converted code keeps the source's file and lines, so a
        # traceback or a birth site points at the user's own line
        ast.increment_lineno(new_tree, fn.__code__.co_firstlineno - 1)
        code = compile(new_tree, filename=inspect.getsourcefile(fn)
                       or f"<dy2static {fn.__name__}>", mode="exec")
        extra = {"__jst_convert_ifelse": convert_ifelse,
                 "__jst_convert_while": convert_while,
                 "__jst_and": convert_logical_and,
                 "__jst_or": convert_logical_or,
                 "__jst_not": convert_logical_not,
                 "__jst_range3": loop_range3,
                 "__jst_any_tensor": loop_any_tensor,
                 "__jst_range_cond": loop_range_cond,
                 "__jst_flag_ok": loop_flag_ok,
                 "__jst_is_py_true": loop_is_py_true,
                 "__jst_index0": loop_index0,
                 "__jst_seq_len": loop_seq_len,
                 "__jst_dyn_index": loop_dyn_index,
                 "__jst_first_elem": loop_first_elem,
                 "__jst_list_append": convert_list_append}
        # closures: materialize free variables as globals of the new fn
        if fn.__closure__:
            for name, cell in zip(fn.__code__.co_freevars, fn.__closure__):
                try:
                    extra[name] = cell.cell_contents
                except ValueError:
                    pass
        globs = _GlobalsProxy(fn.__globals__, extra)
        ns = {}
        exec(code, globs, ns)
        new_fn = ns[fn.__name__]
        functools.update_wrapper(new_fn, fn)
        new_fn.__wrapped_dy2static__ = True
        return new_fn
    except (OSError, TypeError, SyntaxError) as e:
        warnings.warn(f"dy2static: could not convert {fn!r} ({e}); "
                      "tensor-dependent python control flow keeps Python "
                      "semantics (a Tensor if raises under capture)")
        return fn
