"""AsyncLLMEngine: an asyncio front end over LLMEngine.

The port of ``qspec_tpu/engine/async_engine.py``: a background task drives
``LLMEngine.step`` off the event loop, each request streams its incremental
RequestOutputs through an ``asyncio.Queue``, and the death of the loop
reaches every waiter as ``AsyncEngineDeadError``.

Every call into the engine (``step``, ``add_request``, ``abort_request``)
runs on one worker thread, one at a time, and the loop awaits each step
before it starts the next. Two steps must never overlap: the split-counter
buffer of ``csrc/w4.cu`` and ``csrc/w4a16_g.cu`` is shared per device
(``ops/linear_kernels.py::_split_counters``), and the sampler's generator
is the engine's own. A request added while a step runs joins the next one.
"""

from __future__ import annotations

import asyncio
import functools
from concurrent.futures import ThreadPoolExecutor
from typing import AsyncIterator, Dict, List, Optional

from qspec_tpu_torch.engine.llm_engine import LLMEngine, RequestOutput
from qspec_tpu_torch.sampling_params import SamplingParams


class AsyncEngineDeadError(RuntimeError):
    pass


class AsyncLLMEngine:
    def __init__(self, engine: LLMEngine):
        self.engine = engine
        self._queues: Dict[int, asyncio.Queue] = {}
        self._task: Optional[asyncio.Task] = None
        self._wake: Optional[asyncio.Event] = None
        self._dead: Optional[BaseException] = None
        # the one thread every engine call runs on, in submission order
        self._worker = ThreadPoolExecutor(max_workers=1,
                                          thread_name_prefix="qspec-engine")

    async def _call(self, fn, *args, **kw):
        return await asyncio.get_running_loop().run_in_executor(
            self._worker, functools.partial(fn, *args, **kw))

    # ------------------------------------------------------------------
    def _ensure_loop(self):
        # a new step loop (the first, or one on another event loop after
        # the last one's ended) with its own wake-up event
        if self._task is None or self._task.done():
            self._wake = asyncio.Event()
            self._task = asyncio.get_running_loop().create_task(self._run())

    async def _run(self):
        try:
            while True:
                if not self.engine.has_unfinished_requests():
                    self._wake.clear()
                    await self._wake.wait()
                outputs: List[RequestOutput] = await self._call(self.engine.step)
                for out in outputs:
                    q = self._queues.get(out.request_id)
                    if q is not None:
                        q.put_nowait(out)
                        if out.finished:
                            self._queues.pop(out.request_id, None)
        except asyncio.CancelledError:
            raise
        except BaseException as e:  # engine dead: fail every waiter
            self._dead = e
            for q in self._queues.values():
                q.put_nowait(e)
            self._queues.clear()
            raise

    # ------------------------------------------------------------------
    async def run(self, fn, *args, **kw):
        """``fn(*args, **kw)`` on the engine's worker thread, between two
        steps (the LoRA routes write the adapter bank this way)."""
        return await self._call(fn, *args, **kw)

    async def generate(self, prompt_token_ids: List[int],
                       sampling_params: SamplingParams,
                       request_id: Optional[int] = None,
                       lora_name: Optional[str] = None) -> AsyncIterator[RequestOutput]:
        """Stream a request's outputs until its finished one (under the
        adapter ``lora_name``). A refused request raises what
        ``LLMEngine.add_request`` raises."""
        if self._dead is not None:
            raise AsyncEngineDeadError("engine loop died") from self._dead
        self._ensure_loop()
        q: asyncio.Queue = asyncio.Queue()
        rid = await self._call(self.engine.add_request, prompt_token_ids, sampling_params,
                               request_id, lora_name=lora_name)
        self._queues[rid] = q
        self._wake.set()
        try:
            while True:
                item = await q.get()
                if isinstance(item, BaseException):
                    raise AsyncEngineDeadError("engine loop died") from item
                yield item
                if item.finished:
                    return
        finally:
            if self._queues.pop(rid, None) is not None and self._dead is None:
                # the caller left before the request finished (a closed
                # stream): drop it from the engine
                await self._call(self.engine.abort_request, rid)

    async def abort(self, request_id: int):
        self._queues.pop(request_id, None)
        await self._call(self.engine.abort_request, request_id)

    def is_running(self) -> bool:
        return self._dead is None

    async def shutdown(self):
        """Stop the step loop and the worker thread."""
        if self._task is not None and not self._task.done():
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        self._worker.shutdown(wait=True)
