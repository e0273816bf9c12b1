"""ReAct-style agent loop for the chat CLI (a copy of
callireader_tpu/runtime/agent.py; the prompts are data and stay byte-equal).

Parity target: the reference chat tool's lagent mode
(train/xtuner/tools/chat.py:172-213 — lagent ReAct + ActionExecutor +
CALL_PROTOCOL/FORCE_STOP prompts). Re-implemented self-contained (lagent is a
GPU-stack dependency): the protocol prompt instructs the model to emit
Thought / Action / Action Input blocks; the executor runs the named tool and
feeds a Response block back; the loop ends on Final Answer or a force-stop
after ``max_turns``.

Tools default to the plugin set the reference ships (calculate / solve /
search — runtime/plugins.py, whose solve takes linear systems); pass
``tools`` to extend. The model is accessed through a ``chat_fn(question,
history) -> (text, history)`` callable so the loop composes with any engine
(and is unit-testable with a scripted fn).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Tuple

from callireader_tpu_torch.runtime import plugins

ChatFn = Callable[..., Tuple[str, Optional[List]]]

CALL_PROTOCOL = """你是一个可以调用外部工具的助手。可用工具：
{tool_descriptions}
回答问题时严格使用如下格式：
Thought: 你的思考过程
Action: 工具名（必须是上面列出的一个）
Action Input: 传给工具的输入
收到工具结果（Response: 开头）后可以继续思考和调用工具。
当你能回答问题时，输出：
Final Answer: 最终回答
开始！
问题：{question}"""

FORCE_STOP = (
    "你调用工具的次数已达上限。请基于已有信息直接输出 Final Answer: 开头的最终回答。"
)

_ACTION_RE = re.compile(r"Action:\s*(.+?)\s*[\n$]", re.DOTALL)
# Action Input may span lines (e.g. equation systems for solve); capture
# until the next protocol section or end of text
_INPUT_RE = re.compile(
    r"Action Input:\s*(.+?)\s*"
    r"(?=\n(?:Thought:|Action:|Final Answer:|Response:)|\Z)",
    re.DOTALL,
)


def default_tools() -> Dict[str, Tuple[str, Callable[[str], str]]]:
    return {
        "calculate": ("计算数学表达式，如 1+2*3", lambda s: plugins.calculate(s)),
        "solve": ("解方程（组），如 x+y=2, x-y=0", lambda s: plugins.solve_equations(s)),
        "search": ("搜索问题（离线环境返回占位说明）", lambda s: plugins.search_offline(s)),
    }


class ReActAgent:
    def __init__(
        self,
        chat_fn: ChatFn,
        tools: Optional[Dict[str, Tuple[str, Callable[[str], str]]]] = None,
        max_turns: int = 4,
    ):
        self.chat_fn = chat_fn
        self.tools = tools if tools is not None else default_tools()
        self.max_turns = max_turns
        self.history: Optional[List] = None

    def reset(self) -> None:
        self.history = None

    def _protocol(self, question: str) -> str:
        descs = "\n".join(f"- {name}: {desc}" for name, (desc, _) in self.tools.items())
        return CALL_PROTOCOL.format(tool_descriptions=descs, question=question)

    def chat(self, question: str) -> str:
        """Run the ReAct loop for one user question. Returns the final
        answer; the intermediate Thought/Action/Response trace accumulates in
        ``self.history`` (inspect for debugging)."""
        prompt = self._protocol(question)
        for turn in range(self.max_turns + 1):
            text, self.history = self.chat_fn(prompt, self.history)
            if "Final Answer:" in text:
                return text.split("Final Answer:", 1)[1].strip()
            action = _ACTION_RE.search(text + "\n")
            arg = _INPUT_RE.search(text + "\n")
            if action is None:
                # no tool call and no final answer: treat the turn as final
                return text.strip()
            name = action.group(1).strip().strip("（）()`'\"").lower()
            tool = self.tools.get(name)
            if tool is None:
                prompt = (
                    f"Response: 未知工具 {name!r}；可用工具: "
                    f"{', '.join(self.tools)}。请修正 Action。"
                )
                continue
            if turn == self.max_turns:
                # out of turns: the tool result could never be sent back, so
                # don't execute it — surface the model's last reasoning with
                # an explicit truncation note instead of the raw Action block
                thought = re.search(r"Thought:\s*(.+?)\s*(?:\n|$)", text)
                last = thought.group(1).strip() if thought else text.strip()
                return f"（已达到最大工具调用轮数，未得出 Final Answer）{last}"
            tool_input = arg.group(1).strip() if arg else ""
            try:
                result = tool[1](tool_input)
            except Exception as e:  # tool errors go back to the model
                result = f"工具执行出错: {e}"
            prompt = (
                f"Response: {result}" if turn < self.max_turns - 1
                else f"Response: {result}\n{FORCE_STOP}"
            )
        return text.strip()  # unreachable; loop always returns
