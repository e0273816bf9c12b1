"""Chat tool plugins: calculate / solve / search (a copy of
callireader_tpu/runtime/plugins.py; the port imports nothing of the JAX
package).

Parity target: train/xtuner/tools/plugins/ — the chat CLI's inner-thoughts
protocol (api.py:5-43): scan the model turn for ``Calculate("...")``,
``Solve("...")``, ``Search("...")`` calls, execute them, and return a
``<|Results|>: ... <eor>`` block that is fed back as the next model input.

Differences from the reference (deliberate, as in the JAX module):
  - Calculate uses a whitelisted AST evaluator instead of raw ``eval``.
  - Solve runs sympy (a requirement of torch), imported inside the call so
    that importing the port never loads it.
  - Search is an offline stub; a custom ``search_fn`` can be injected for
    deployments with network access.
"""

from __future__ import annotations

import ast
import math
import operator
import re
from typing import Callable, Optional

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


def solve_equations(equations_str: str) -> str:
    """Symbolic equation solving (plugins/solve.py behavior: implicit
    multiplication insertion, ','/';' separated, '=' or bare expressions).
    sympy is imported here, not with the module."""
    try:
        import sympy

        s = equations_str.replace(" ", "").replace("^", "**")
        s = re.sub(r"(\(.*\))([a-zA-Z])", r"\1 * \2", s)
        s = re.sub(r"(\d+)([a-zA-Z])", r"\1 * \2", s)
        s = s.replace("pi", str(math.pi))
        parts = [p for p in re.split(r"[,;]+", s) if p]
        var_names = sorted(set(re.findall(r"[a-zA-Z]+", s)))
        syms = {v: sympy.symbols(v) for v in var_names}
        eqs = []
        for p in parts:
            if "=" in p:
                left, right = p.split("=")
                eqs.append(sympy.Eq(sympy.sympify(left, syms), sympy.sympify(right, syms)))
            else:
                eqs.append(sympy.sympify(p, syms))
        sol = sympy.solve(eqs, list(syms.values()), dict=True)
        if not sol:
            return "No solution."
        lines = []
        for s_ in sol:
            lines.append(", ".join(f"{k} = {sympy.nsimplify(v)}" for k, v in s_.items()))
        return "\n".join(lines)
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
