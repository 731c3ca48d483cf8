"""LLM providers: Anthropic Batches, OpenAI-compatible local, mock.

Reference analog: ``src/llm/mod.rs`` (Claude Batches API — create a batch of
requests, poll, collect results; half-price path for offline enrichment) and
``src/llm/local.rs`` (OpenAI-compatible ``/v1/chat/completions`` for local
servers like vLLM / llama.cpp / ollama).
"""

from __future__ import annotations

import json
import os
import time
import urllib.error
import urllib.request
from dataclasses import dataclass


@dataclass
class LLMRequest:
    custom_id: str
    prompt: str
    max_tokens: int = 400
    system: str = ""


class LLMProvider:
    """Interface: submit a batch of prompts, get {custom_id: text} back."""

    name = "base"

    def complete_batch(self, requests: list[LLMRequest]) -> dict[str, str]:
        raise NotImplementedError

    def available(self) -> bool:
        return False


class MockProvider(LLMProvider):
    """Deterministic offline provider for tests: echoes a template summary."""

    name = "mock"

    def __init__(self, template: str = "Summary of {id}."):
        self.template = template
        self.calls: list[LLMRequest] = []

    def complete_batch(self, requests: list[LLMRequest]) -> dict[str, str]:
        self.calls.extend(requests)
        return {r.custom_id: self.template.format(id=r.custom_id) for r in requests}

    def available(self) -> bool:
        return True


class OpenAICompatProvider(LLMProvider):
    """OpenAI-compatible chat completions (local vLLM/llama.cpp/ollama)."""

    name = "openai-compat"

    def __init__(self, base_url: str | None = None, model: str | None = None,
                 api_key: str | None = None, timeout: float = 120.0):
        self.base_url = (base_url or os.environ.get("CQST_LLM_BASE_URL", "")).rstrip("/")
        self.model = model or os.environ.get("CQST_LLM_MODEL", "local")
        self.api_key = api_key or os.environ.get("CQST_LLM_API_KEY", "")
        self.timeout = timeout

    def available(self) -> bool:
        return bool(self.base_url)

    def _call(self, req: LLMRequest) -> str | None:
        body = {
            "model": self.model,
            "messages": ([{"role": "system", "content": req.system}] if req.system else [])
            + [{"role": "user", "content": req.prompt}],
            "max_tokens": req.max_tokens,
            "temperature": 0.2,
        }
        http_req = urllib.request.Request(
            self.base_url + "/v1/chat/completions",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json",
                     **({"Authorization": f"Bearer {self.api_key}"} if self.api_key else {})})
        try:
            with urllib.request.urlopen(http_req, timeout=self.timeout) as resp:
                data = json.loads(resp.read())
            return data["choices"][0]["message"]["content"]
        except (urllib.error.URLError, KeyError, json.JSONDecodeError, TimeoutError):
            return None

    def complete_batch(self, requests: list[LLMRequest]) -> dict[str, str]:
        out: dict[str, str] = {}
        for r in requests:
            text = self._call(r)
            if text is not None:
                out[r.custom_id] = text
        return out


class AnthropicBatchProvider(LLMProvider):
    """Anthropic Message Batches API (the reference's discount path)."""

    name = "anthropic-batches"
    API = "https://api.anthropic.com/v1"

    def __init__(self, api_key: str | None = None,
                 model: str | None = None, poll_s: float = 10.0,
                 max_wait_s: float = 3600.0):
        self.api_key = api_key or os.environ.get("ANTHROPIC_API_KEY", "")
        self.model = model or os.environ.get("CQST_LLM_MODEL", "claude-3-5-haiku-latest")
        self.poll_s = poll_s
        self.max_wait_s = max_wait_s

    def available(self) -> bool:
        return bool(self.api_key)

    def _headers(self) -> dict:
        return {"x-api-key": self.api_key, "anthropic-version": "2023-06-01",
                "Content-Type": "application/json"}

    def _post(self, path: str, body: dict) -> dict:
        req = urllib.request.Request(self.API + path, data=json.dumps(body).encode(),
                                     headers=self._headers())
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read())

    def _get(self, url: str) -> bytes:
        req = urllib.request.Request(url, headers=self._headers())
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.read()

    def complete_batch(self, requests: list[LLMRequest]) -> dict[str, str]:
        batch_reqs = [{
            "custom_id": r.custom_id,
            "params": {
                "model": self.model,
                "max_tokens": r.max_tokens,
                **({"system": r.system} if r.system else {}),
                "messages": [{"role": "user", "content": r.prompt}],
            },
        } for r in requests]
        try:
            batch = self._post("/messages/batches", {"requests": batch_reqs})
            batch_id = batch["id"]
            deadline = time.time() + self.max_wait_s
            while time.time() < deadline:
                status = json.loads(self._get(f"{self.API}/messages/batches/{batch_id}"))
                if status.get("processing_status") == "ended":
                    results_url = status.get("results_url")
                    out: dict[str, str] = {}
                    if results_url:
                        for line in self._get(results_url).decode().splitlines():
                            rec = json.loads(line)
                            res = rec.get("result", {})
                            if res.get("type") == "succeeded":
                                blocks = res["message"]["content"]
                                text = "".join(b.get("text", "") for b in blocks)
                                out[rec["custom_id"]] = text
                    return out
                time.sleep(self.poll_s)
        except (urllib.error.URLError, KeyError, json.JSONDecodeError, TimeoutError):
            pass
        return {}


def provider_from_env() -> LLMProvider | None:
    """Provider resolution: explicit local URL > Anthropic key > none."""
    local = OpenAICompatProvider()
    if local.available():
        return local
    anthropic = AnthropicBatchProvider()
    if anthropic.available():
        return anthropic
    return None
