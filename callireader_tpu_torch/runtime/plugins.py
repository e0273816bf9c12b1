"""Chat tool plugins: calculate / solve / search (a copy of
callireader_tpu/runtime/plugins.py; the port imports nothing of the JAX
package).

Parity target: train/xtuner/tools/plugins/ — the chat CLI's inner-thoughts
protocol (api.py:5-43): scan the model turn for ``Calculate("...")``,
``Solve("...")``, ``Search("...")`` calls, execute them, and return a
``<|Results|>: ... <eor>`` block that is fed back as the next model input.

Pure Python (no sympy, no network):
  - Calculate uses a whitelisted AST evaluator instead of raw ``eval``.
  - Solve takes the JAX module's preprocessing (implicit multiplication,
    ``^`` as power, ``,`` / ``;`` separated, ``=`` or bare expressions) and
    solves systems of linear equations exactly in rationals (a decimal
    read at the 15 significant digits of sympy's Float): a unique
    solution prints as the JAX module's sympy route prints it
    (``x = 1, y = 1/3``, variables in sorted order), an inconsistent system
    as ``No solution.``. A nonlinear or underdetermined system, which the
    JAX module hands to sympy, gives ``No result.`` here.
  - Search is an offline stub; a custom ``search_fn`` can be injected for
    deployments with network access.
"""

from __future__ import annotations

import ast
import math
import operator
import re
from fractions import Fraction
from typing import Callable, Dict, List, Optional

CALL_PATTERN = (
    r'(Solve|solve|Solver|solver|Calculate|calculate|Calculator|calculator|Search)'
    r'\("([^"]*)"\)'
)

_BINOPS = {
    ast.Add: operator.add, ast.Sub: operator.sub, ast.Mult: operator.mul,
    ast.Div: operator.truediv, ast.FloorDiv: operator.floordiv,
    ast.Mod: operator.mod, ast.Pow: operator.pow,
}
_UNARY = {ast.UAdd: operator.pos, ast.USub: operator.neg}
_NAMES = {
    "pi": math.pi, "e": math.e, "sqrt": math.sqrt, "log": math.log,
    "log2": math.log2, "log10": math.log10, "exp": math.exp, "sin": math.sin,
    "cos": math.cos, "tan": math.tan, "asin": math.asin, "acos": math.acos,
    "atan": math.atan, "abs": abs, "floor": math.floor, "ceil": math.ceil,
    "round": round, "pow": pow, "factorial": math.factorial,
}


def _safe_eval(node: ast.AST) -> float:
    if isinstance(node, ast.Expression):
        return _safe_eval(node.body)
    if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
        return node.value
    if isinstance(node, ast.BinOp) and type(node.op) in _BINOPS:
        return _BINOPS[type(node.op)](_safe_eval(node.left), _safe_eval(node.right))
    if isinstance(node, ast.UnaryOp) and type(node.op) in _UNARY:
        return _UNARY[type(node.op)](_safe_eval(node.operand))
    if isinstance(node, ast.Name) and node.id in _NAMES:
        return _NAMES[node.id]
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in _NAMES:
        return _NAMES[node.func.id](*[_safe_eval(a) for a in node.args])
    raise ValueError(f"disallowed expression node: {ast.dump(node)}")


def calculate(expression: str) -> str:
    """';'-separated arithmetic, '^' as power, 2-decimal results
    (plugins/calculate.py semantics with a safe evaluator)."""
    out = []
    for exp in expression.split(";"):
        try:
            val = _safe_eval(ast.parse(exp.replace("^", "**").strip(), mode="eval"))
            out.append(f"{val:.2f}")
        except Exception:  # noqa: BLE001
            out.append("No result.")
    return ";".join(out)


# a linear form: {variable: coefficient, "": constant}, exact rationals
Linear = Dict[str, Fraction]


def _lin_const(form: Linear) -> Optional[Fraction]:
    return form.get("", Fraction(0)) if all(k == "" or c == 0 for k, c in form.items()) else None


def _lin_add(a: Linear, b: Linear, sign: int = 1) -> Linear:
    out = dict(a)
    for k, c in b.items():
        out[k] = out.get(k, Fraction(0)) + sign * c
    return out


def _lin_scale(a: Linear, s: Fraction) -> Linear:
    return {k: c * s for k, c in a.items()}


def _linear(node: ast.AST, names: List[str]) -> Linear:
    """An expression of numbers and variables -> its linear form; raises
    ValueError where it is not linear."""
    if isinstance(node, ast.Expression):
        return _linear(node.body, names)
    if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)) \
            and not isinstance(node.value, bool):
        # a decimal at the 15 significant digits of sympy's Float
        return {"": Fraction(format(node.value, ".15g")) if isinstance(node.value, float)
                else Fraction(node.value)}
    if isinstance(node, ast.Name) and node.id in names:
        return {node.id: Fraction(1)}
    if isinstance(node, ast.UnaryOp) and type(node.op) in _UNARY:
        inner = _linear(node.operand, names)
        return inner if isinstance(node.op, ast.UAdd) else _lin_scale(inner, Fraction(-1))
    if isinstance(node, ast.BinOp):
        a, b = _linear(node.left, names), _linear(node.right, names)
        ca, cb = _lin_const(a), _lin_const(b)
        if isinstance(node.op, (ast.Add, ast.Sub)):
            return _lin_add(a, b, 1 if isinstance(node.op, ast.Add) else -1)
        if isinstance(node.op, ast.Mult) and (ca is not None or cb is not None):
            return _lin_scale(b, ca) if ca is not None else _lin_scale(a, cb)
        if isinstance(node.op, ast.Div) and cb is not None and cb != 0:
            return _lin_scale(a, 1 / cb)
        if isinstance(node.op, ast.Pow) and cb is not None and cb.denominator == 1:
            if ca is not None and (ca != 0 or cb >= 0):
                return {"": ca ** int(cb)}
            if cb == 1:
                return a
    raise ValueError(f"not a linear expression: {ast.dump(node)}")


def _solve_linear(rows: List[List[Fraction]], n: int):
    """Gauss-Jordan on the augmented rows -> the unique solution, None when
    the system is inconsistent; raises ValueError when it is
    underdetermined."""
    rows = [r[:] for r in rows]
    pivots, r = [], 0
    for col in range(n):
        piv = next((i for i in range(r, len(rows)) if rows[i][col] != 0), None)
        if piv is None:
            continue
        rows[r], rows[piv] = rows[piv], rows[r]
        lead = rows[r][col]
        rows[r] = [v / lead for v in rows[r]]
        for i in range(len(rows)):
            if i != r and rows[i][col] != 0:
                f = rows[i][col]
                rows[i] = [v - f * w for v, w in zip(rows[i], rows[r])]
        pivots.append(col)
        r += 1
    if any(all(v == 0 for v in row[:n]) and row[n] != 0 for row in rows):
        return None
    if len(pivots) < n:
        raise ValueError("underdetermined system")
    return [rows[i][n] for i in range(n)]


def solve_equations(equations_str: str) -> str:
    """Linear equation systems (plugins/solve.py's input rules: implicit
    multiplication insertion, ','/';' separated, '=' or bare expressions),
    solved exactly; see the module docstring for what is not solved."""
    try:
        s = equations_str.replace(" ", "").replace("^", "**")
        s = re.sub(r"(\(.*\))([a-zA-Z])", r"\1 * \2", s)
        s = re.sub(r"(\d+)([a-zA-Z])", r"\1 * \2", s)
        s = s.replace("pi", str(math.pi))
        parts = [p for p in re.split(r"[,;]+", s) if p]
        var_names = sorted(set(re.findall(r"[a-zA-Z]+", s)))
        rows = []
        for p in parts:
            left, right = p.split("=") if "=" in p else (p, "0")
            form = _lin_add(_linear(ast.parse(left, mode="eval"), var_names),
                            _linear(ast.parse(right, mode="eval"), var_names), -1)
            rows.append([form.get(v, Fraction(0)) for v in var_names]
                        + [-form.get("", Fraction(0))])
        sol = _solve_linear(rows, len(var_names))
        if sol is None:
            return "No solution."
        return ", ".join(f"{v} = {x}" for v, x in zip(var_names, sol))
    except Exception:  # noqa: BLE001
        return "No result."


def search_offline(query: str) -> str:
    return f"Search is unavailable offline (query: {query!r})."


def plugins_api(
    input_str: str,
    *,
    calculate_open: bool = True,
    solve_open: bool = True,
    search_open: bool = True,
    search_fn: Optional[Callable[[str], str]] = None,
) -> str:
    """Execute tool calls found in a model turn -> '<|Results|>: ... <eor>'
    feedback block (plugins/api.py:5-43 protocol)."""
    matches = re.findall(CALL_PATTERN, input_str)
    out = "<|Results|>:\n"
    for name, arg in matches:
        lname = name.lower()
        if lname.startswith("calc"):
            result = calculate(arg) if calculate_open else None
            out += f'Calculate("{arg}") => {result}\n'
        elif lname.startswith("solve"):
            result = solve_equations(arg) if solve_open else None
            out += f'Solve("{arg}") =>\n{result}\n'
        elif name == "Search":
            result = (search_fn or search_offline)(arg) if search_open else None
            out += f'Search("{arg}") =>\n{result}'
    out += "<eor>\n"
    return out


class StopWordCriteria:
    """utils/stop_criteria.py:5-16 — stop generation when the decoded tail
    ends with a stop word (token-id level check done on decoded text)."""

    def __init__(self, tokenizer, stop_word: str):
        self.tokenizer = tokenizer
        self.stop_word = stop_word

    def __call__(self, token_ids) -> bool:
        if not self.stop_word:
            return False
        tail = self.tokenizer.decode(list(token_ids)[-12:], skip_special_tokens=False)
        return tail.endswith(self.stop_word)
