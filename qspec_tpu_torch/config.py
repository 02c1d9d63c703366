"""Configuration dataclasses.

The port's own copy of the parts of ``qspec_tpu/config.py`` that the ported
families read, with the same field names and defaults: the dense llama graph
and its knobs (Llama, Mistral, Phi-3 with its longrope, Qwen2 with the qkv
bias, Qwen3 with the q/k norms, Gemma with its tanh GeGLU, embedding scale
and (1+w) norms, Granite with its four multipliers, the reference's QuaRot
``llama_quarot`` / ``qwen2_quarot``; the llama graph under other key names:
Baichuan, InternLM2, Qwen v1, EXAONE, TeleChat2), the Gemma-2 grouped-int4
path, the float families' bf16 path (BLOOM, MPT, Falcon with its parallel
blocks, JAIS, Baichuan-13B's ALiBi; since the gptj rope and partial
rotary, the parallel-residual families GPT-J, GPT-NeoX / Pythia, Phi-2,
StableLM and Cohere, and the llama graph with the gptj rope: GLM-4, Helium)
and the sparse-MoE families (Mixtral, Qwen2-MoE, Qwen3-MoE, DeepSeek-MoE).
Fields of model families, loaders, parallelism and proposers that are not
ported yet are left out rather than accepted and ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters of one dense llama-graph model (Llama,
    Mistral, Phi-3, Qwen2, Qwen3, Gemma, Granite; Baichuan, InternLM2, Qwen
    v1, EXAONE, TeleChat2; GLM-4, Helium), a Gemma-2, a float family's
    (BLOOM, MPT, Falcon, JAIS, GPT-J, GPT-NeoX, Phi-2, StableLM, Cohere) or
    a sparse MoE (Mixtral, Qwen2-MoE, Qwen3-MoE, DeepSeek-MoE)."""

    # "llama" (Mistral and Phi-3 too) | "qwen2" | "qwen3" | "gemma" |
    # "granite" | "gemma2" | "bloom" | "mpt" | "mixtral" | "qwen2moe" |
    # "qwen3moe" | "deepseek" | "falcon" | "jais" | "gptj" | "gpt_neox" |
    # "phi" | "stablelm" | "cohere" | "glm" | "helium"; the llama graph under
    # other key names (model_loader/families.py LLAMA_KEY_REMAPS):
    # "baichuan" | "internlm2" | "qwen" (v1) | "exaone" | "telechat2"
    arch: str = "llama"
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500000.0
    rope_scaling: Optional[dict] = None
    # partial rotary: rope only the first rotary_dim dims of each head, the
    # rest pass through (GPT-NeoX rotary_pct, Phi / StableLM / GLM
    # partial_rotary_factor, GPT-J rotary_dim, Qwen v1 rotary_pct); None:
    # the whole head
    rotary_dim: Optional[int] = None
    # "neox": rotate half-split pairs (x_i, x_{i+d/2}); "gptj": interleaved
    # pairs (x_{2i}, x_{2i+1}) (GPT-J, Cohere, GLM, Helium)
    rope_style: str = "neox"
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 8192
    tie_word_embeddings: bool = False
    # Qwen2-style bias on the q, k and v projections
    qkv_bias: bool = False
    # Qwen3-style per-head RMSNorm of q and k after the projection, before
    # rope ([head_dim] gammas, live under QuaRot too: they sit after the
    # rotated projection); "head" is the only style ported
    qk_norm: bool = False
    qk_norm_style: str = "head"
    # MLP activation: "silu" (llama) | "gelu_tanh" (gemma's approximate
    # GeGLU, HF gelu_pytorch_tanh; BLOOM's gelu; HF gelu_new and gelu_fast:
    # GPT-J, Phi-2, GPT-NeoX-20B) | "gelu" (exact, MPT, Pythia)
    hidden_act: str = "silu"
    # multiply embeddings by this after lookup (gemma: sqrt(hidden_size)),
    # in the hidden dtype
    embed_scale: Optional[float] = None
    # gemma RMSNorm computes x * (1 + w): loaders fold the +1 into the
    # stored gamma so the runtime norm stays the standard x * gamma
    norm_weight_offset: float = 0.0
    # quantization of the stored checkpoint:
    # "w4"   QuaRot packed int4, per-channel symmetric (dual-scheme QSpec);
    #        weightless norms, Hadamard rotations
    # "w4g"  grouped asymmetric int4 (AWQ / GPTQ / compressed-tensors
    #        pack-quantized / GGUF Q4_0, model_loader/grouped.py); gamma
    #        norms, no rotations, W4A16 only
    # "w8"   per-channel byte weights, int8 or float8_e4m3fn
    #        (compressed-tensors int-quantized / float-quantized,
    #        model_loader/ct.py), W8A16: gamma norms, no rotations, its
    #        verify and draft run the W4A16 scheme's slot
    # "none" bf16 weights (the float families: BLOOM, MPT), the bf16 scheme
    quant: str = "w4"
    # vocab-projection weight dtype; "auto" = int8 for quantized checkpoints
    # (the int8 head runs matmul_w8a16, the int4 head matmul_w4a16), bf16
    # for quant="none"
    lm_head_quant: str = "auto"       # "auto" | "bf16" | "int8" | "int4"
    # Mistral-style sliding-window attention: each query attends only to the
    # last `sliding_window` positions; None = full causal attention
    sliding_window: Optional[int] = None
    # gemma2: layer li is sliding iff li % sliding_window_pattern == 0, else
    # global (2 = even layers sliding); tanh softcaps on the attention scores
    # and the final logits; the query scale from query_pre_attn_scalar;
    # post-attention and pre+post-feedforward norms around each block
    sliding_window_pattern: int = 1
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    query_pre_attn_scalar: Optional[float] = None
    post_norms: bool = False
    # Granite's scalar multipliers: each block's output is scaled by
    # residual_multiplier before the residual add, the final logits divided
    # by logits_scaling (embedding_multiplier rides embed_scale,
    # attention_multiplier rides query_pre_attn_scalar as its ** -2)
    residual_multiplier: float = 1.0
    logits_scaling: Optional[float] = None
    # the GPT-family graph knobs of the float families (BLOOM, MPT), served
    # as bf16 checkpoints only: "layernorm" is mean-subtracting with an
    # optional bias (layers.input_norm_b / post_norm_b, final_norm_b)
    norm_type: str = "rmsnorm"        # "rmsnorm" | "layernorm"
    # False: fc1 -> act -> fc2, "gate_up" holding fc1 [H, I]
    mlp_gated: bool = True
    # "alibi": per-head slopes bias the attention scores (ops/attention.py
    # alibi_slopes), no rope
    position_embedding: str = "rope"  # "rope" | "alibi"
    # a bias on every projection, o and down included
    linear_bias: bool = False
    # clamp the qkv projection to [-clip_qkv, clip_qkv] (MPT attn_config)
    clip_qkv: Optional[float] = None
    # Falcon's parallel blocks: x + attn(norm(x)) + mlp(norm'(x)), where the
    # MLP reads the attention's normed input (parallel_norms 1: Falcon-7B)
    # or its own norm of the same residual (2: Falcon-40B's ln_mlp,
    # layers["post_norm"]); served with bf16 weights
    parallel_block: bool = False
    parallel_norms: int = 1
    # an additive bias on the vocab projection (Phi, GPT-J), params
    # ["lm_head_b"] f32-added to the logits after logits_scaling
    lm_head_bias: bool = False
    # sparse MoE (models/llama.py _moe_block): each layer's MLP is
    # num_experts expert MLPs of width moe_intermediate_size (None: the
    # dense width) mixed by a router's top num_experts_per_tok; 0 = dense
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_intermediate_size: Optional[int] = None
    # an always-on shared expert of this width (0: none), its output gated
    # by sigmoid(x @ shared_gate) (Qwen2-MoE) or added as is (DeepSeek)
    shared_expert_intermediate_size: int = 0
    shared_expert_gated: bool = True
    # renormalize the top-k weights to sum 1
    moe_norm_topk_prob: bool = False
    # softmax over all experts, then top-k (Qwen-MoE, DeepSeek); False:
    # top-k of the logits, then a softmax over the winners (Mixtral)
    moe_softmax_before_topk: bool = False
    # "topk" (refined by the two flags above) | "sparsemixer" (Phi-3.5-MoE)
    # | "noaux_tc" (DeepSeek-V3: sigmoid scores, a per-expert selection
    # bias, group-limited to the moe_topk_group best of moe_n_group groups)
    moe_routing: str = "topk"
    moe_n_group: int = 1
    moe_topk_group: int = 1
    # DeepSeek-MoE: the first first_k_dense layers keep a dense MLP
    # (params["layers_dense"]); the KV cache still counts layers globally
    first_k_dense: int = 0
    # the routed experts' sum is scaled by this before the shared expert
    # adds (DeepSeek-V2/V3)
    routed_scaling_factor: float = 1.0
    # DeepSeek-V2 multi-head latent attention ("mla": DeepSeek-V2 / V3,
    # MiniCPM3; models/llama.py _mla_attention): keys and values come from a
    # shared low-rank latent c_kv [kv_lora_rank] and one decoupled rope key
    # [qk_rope_head_dim]; the cache keeps one latent row a token (MQA over
    # the latent, cache_kv_heads 1) and W_UK / W_UV fold into the query and
    # output sides. q_lora_rank None: a direct q projection. "mha": the
    # standard attention
    attention_type: str = "mha"       # "mha" | "mla"
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    def __post_init__(self):
        allowed = (("quant", ("w4", "w4g", "w8", "none")),
                   ("arch", ("llama", "qwen2", "qwen3", "gemma", "granite", "gemma2",
                             "bloom", "mpt", "mixtral", "qwen2moe", "qwen3moe",
                             "deepseek", "falcon", "jais", *REMAP_ARCHS, "gptj",
                             "gpt_neox", "phi", "stablelm", "cohere", "glm", "helium",
                             "deepseek_v2", "deepseek_v3")),
                   ("attention_type", ("mha", "mla")),
                   ("hidden_act", ("silu", "gelu_tanh", "gelu")),
                   ("norm_type", ("rmsnorm", "layernorm")),
                   ("position_embedding", ("rope", "alibi")),
                   ("qk_norm_style", ("head",)),
                   ("rope_style", ("neox", "gptj")),
                   ("moe_routing", ("topk", "sparsemixer", "noaux_tc")),
                   ("parallel_norms", (1, 2)))
        for name, values in allowed:
            if getattr(self, name) not in values:
                raise NotImplementedError(f"{name}={getattr(self, name)!r}: the port "
                                          f"takes {', '.join(map(repr, values))}")
        if self.rotary_dim is not None and not (
                0 < self.rotary_dim <= self.head_dim and self.rotary_dim % 2 == 0):
            raise ValueError(f"rotary_dim={self.rotary_dim}: an even width in (0, "
                             f"head_dim={self.head_dim}]")
        if self.attention_type == "mla" and not (
                self.kv_lora_rank > 0 and self.qk_rope_head_dim > 0
                and self.qk_rope_head_dim % 2 == 0 and self.qk_nope_head_dim > 0
                and self.v_head_dim > 0 and (self.q_lora_rank is None or self.q_lora_rank > 0)
                and self.head_dim == self.qk_nope_head_dim + self.qk_rope_head_dim
                and self.rope_dim == self.qk_rope_head_dim):
            raise ValueError(
                f"MLA: kv_lora_rank={self.kv_lora_rank}, q_lora_rank={self.q_lora_rank}, "
                f"qk_nope_head_dim={self.qk_nope_head_dim}, qk_rope_head_dim="
                f"{self.qk_rope_head_dim} (even), v_head_dim={self.v_head_dim} all positive, "
                f"head_dim={self.head_dim} their qk sum and rotary_dim={self.rotary_dim} "
                "the rope width")

    @property
    def resolved_lm_head_quant(self) -> str:
        if self.lm_head_quant != "auto":
            return self.lm_head_quant
        # the JAX package's default: int8 for a quantized checkpoint, the
        # bf16 head of a float one
        return "bf16" if self.quant == "none" else "int8"

    @property
    def scaling_window(self) -> Optional[int]:
        """The positions inside which the checkpoint's position scaling
        leaves rope and attention plain: a dynamic NTK rope_scaling's
        ``original_max_position_embeddings`` (InternLM2's
        max_position_embeddings; Qwen v1's seq_length, past which its
        use_dynamic_ntk and use_logn_attn act). The port serves such a
        model only inside it (EngineConfig, ops/rotary.py); None: no such
        scaling."""
        rs = self.rope_scaling
        if rs and rs.get("rope_type", rs.get("type")) == "dynamic":
            return rs["original_max_position_embeddings"]
        return None

    @property
    def rope_dim(self) -> int:
        """The rotated width of a head: the rope cache is built at it."""
        return self.rotary_dim or self.head_dim

    @property
    def expert_intermediate_size(self) -> int:
        return self.moe_intermediate_size or self.intermediate_size

    @property
    def cache_kv_heads(self) -> int:
        # MLA caches one latent "head" a token
        return 1 if self.attention_type == "mla" else self.num_kv_heads

    @property
    def cache_head_dim(self) -> int:
        # MLA's latent row, kv_lora_rank + qk_rope_head_dim, and small head
        # dims are stored 128-padded, as in the JAX package: the attention
        # kernel takes head dims 128, 256, 384 and 640; update_layer
        # zero-pads writes and ops.attention.paged_attention pads q and
        # slices back
        d = (self.kv_lora_rank + self.qk_rope_head_dim if self.attention_type == "mla"
             else self.head_dim)
        return -(-d // 128) * 128

    @property
    def q_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def qkv_out(self) -> int:
        return self.q_size + 2 * self.kv_size

    @staticmethod
    def llama3_8b(**over) -> "ModelConfig":
        return ModelConfig(**over)

    @staticmethod
    def gemma2_9b(**over) -> "ModelConfig":
        """google/gemma-2-9b's published config.json, as from_hf_config
        reads it; ``over`` replaces fields of the result."""
        return dataclasses.replace(ModelConfig.from_hf_config(GEMMA2_9B_HF), **over)

    @staticmethod
    def bloom_7b1(**over) -> "ModelConfig":
        """bigscience/bloom-7b1's published config.json, as from_hf_config
        reads it; ``over`` replaces fields of the result."""
        return dataclasses.replace(ModelConfig.from_hf_config(BLOOM_7B1_HF), **over)

    @staticmethod
    def qwen15_moe_a2_7b(**over) -> "ModelConfig":
        """Qwen/Qwen1.5-MoE-A2.7B (the JAX package's preset): 60 experts of
        width 1408, top-4, a gated shared expert of 5632, the qkv bias."""
        d = dict(arch="qwen2moe", vocab_size=151936, hidden_size=2048,
                 intermediate_size=5632, num_layers=24, num_heads=16,
                 num_kv_heads=16, head_dim=128, rope_theta=1000000.0,
                 max_position_embeddings=8192, qkv_bias=True,
                 num_experts=60, num_experts_per_tok=4,
                 moe_intermediate_size=1408,
                 shared_expert_intermediate_size=5632,
                 moe_softmax_before_topk=True)
        d.update(over)
        return ModelConfig(**d)

    @staticmethod
    def mixtral_8x7b(**over) -> "ModelConfig":
        """mistralai/Mixtral-8x7B (the JAX package's preset): 32 layers of 8
        experts of width 14336, top-2."""
        d = dict(arch="mixtral", vocab_size=32000, hidden_size=4096,
                 intermediate_size=14336, num_layers=32, num_heads=32,
                 num_kv_heads=8, rope_theta=1000000.0,
                 max_position_embeddings=32768, num_experts=8,
                 num_experts_per_tok=2)
        d.update(over)
        return ModelConfig(**d)

    @staticmethod
    def llama3_70b(**over) -> "ModelConfig":
        d = dict(hidden_size=8192, intermediate_size=28672, num_layers=80,
                 num_heads=64, num_kv_heads=8)
        d.update(over)
        return ModelConfig(**d)

    @staticmethod
    def qwen2_7b(**over) -> "ModelConfig":
        """Qwen/Qwen2-7B (the JAX package's preset): 28 layers, hidden 3584,
        intermediate 18944, 28 query heads over 4 KV heads, the qkv bias."""
        d = dict(arch="qwen2", vocab_size=152064, hidden_size=3584,
                 intermediate_size=18944, num_layers=28, num_heads=28,
                 num_kv_heads=4, rope_theta=1000000.0, qkv_bias=True,
                 max_position_embeddings=32768)
        d.update(over)
        return ModelConfig(**d)

    @staticmethod
    def gemma_7b(**over) -> "ModelConfig":
        d = dict(arch="gemma", vocab_size=256000, hidden_size=3072,
                 intermediate_size=24576, num_layers=28, num_heads=16,
                 num_kv_heads=16, head_dim=256, rope_theta=10000.0,
                 max_position_embeddings=8192, tie_word_embeddings=True,
                 hidden_act="gelu_tanh", embed_scale=3072.0 ** 0.5,
                 norm_weight_offset=1.0)
        d.update(over)
        return ModelConfig(**d)

    @staticmethod
    def gemma_2b(**over) -> "ModelConfig":
        d = dict(arch="gemma", vocab_size=256000, hidden_size=2048,
                 intermediate_size=16384, num_layers=18, num_heads=8,
                 num_kv_heads=1, head_dim=256, rope_theta=10000.0,
                 max_position_embeddings=8192, tie_word_embeddings=True,
                 hidden_act="gelu_tanh", embed_scale=2048.0 ** 0.5,
                 norm_weight_offset=1.0)
        d.update(over)
        return ModelConfig(**d)

    @staticmethod
    def from_hf_config(hf: dict) -> "ModelConfig":
        """Build from a Hugging Face config.json dict, with the fields
        ``qspec_tpu/config.py``'s ``from_hf_config`` gives them. The model
        type is read as the JAX package reads it, by substring (so the
        reference's ``llama_quarot`` is a llama, ``qwen2_quarot`` a qwen2):
        bloom, mpt and deepseek have their own readers; qwen3_moe, qwen3,
        qwen2_moe, qwen2, mixtral, gemma2, gemma, granite, and llama, mistral
        and phi3 (all three the llama arch) the llama graph's. Any other
        model type raises, and so do the families whose type holds one of
        those names but whose graph the port lacks (``UNPORTED_TYPES``).

        Two readings follow Hugging Face where the JAX package does not
        (ROADMAP §3): a dense Qwen2 / Qwen3 gets no window unless
        ``use_sliding_window`` is set (one that windows only the layers
        from ``max_window_layers`` on raises), and Phi-3's top-level
        ``original_max_position_embeddings`` goes into its longrope
        scaling.

        The llama graph under other key names reads as the JAX package
        reads it: baichuan and internlm2 by substring, on the llama branch
        (Baichuan ALiBi where the registry says so; an InternLM2 with
        ``bias`` raises), and Qwen v1, EXAONE and TeleChat2 (``qwen``,
        ``exaone``, ``telechat2`` / ``telechat``) by their own readers; so
        do Falcon (``falcon``, ``RefinedWeb``, ``RefinedWebModel``) and
        JAIS. Past the JAX package, a dynamic NTK rope (Qwen v1's logn
        attention too) records its window (``scaling_window``: served only
        inside it) and Qwen v1 reads its base from ``rotary_emb_base``.

        The parallel-residual families (``gptj``, ``gpt_neox``, ``phi``,
        ``stablelm``, ``cohere``) read as the JAX package's branches read
        them, and ``glm`` and ``helium`` as its registry does; a layout
        whose graph the port lacks raises (``REFUSED``: Cohere's
        ``use_qk_norm``, ``cohere2``, StableLM's ``qk_layernorm`` and
        parallel residual, Phi's ``qk_layernorm``, ``glm4``'s post-block
        norms), where the JAX package reads most of them wrong without a
        word (ROADMAP §3)."""
        mt = hf.get("model_type", "")
        own = {"bloom": _from_bloom, "mpt": _from_mpt, "deepseek": _from_deepseek,
               "deepseek_v2": _from_deepseek_v2,
               "falcon": _from_falcon, "RefinedWeb": _from_falcon,
               "RefinedWebModel": _from_falcon, "jais": _from_jais, "qwen": _from_qwen1,
               "exaone": _from_exaone, "telechat2": _from_telechat2,
               "telechat": _from_telechat2, "gptj": _from_gptj, "gpt_neox": _from_gpt_neox,
               "phi": _from_phi, "stablelm": _from_stablelm, "cohere": _from_cohere,
               "glm": _from_glm, "helium": _from_helium}
        _refuse(mt, hf)
        if mt in own:
            return own[mt](hf)
        bad = next((f for f in UNPORTED_TYPES if f in mt), None)
        arch = None if bad else next((a for f, a in LLAMA_GRAPH_TYPES if f in mt), None)
        if arch is None:
            raise NotImplementedError(
                f"model_type {mt!r}: the port reads model types holding "
                f"{', '.join(f for f, _ in LLAMA_GRAPH_TYPES)}, or "
                f"{', '.join(own)}" + (f"; {bad!r} names a family not ported (ROADMAP "
                                       "queue 1 item 9)" if bad else ""))
        if arch == "internlm2" and hf.get("bias"):
            raise NotImplementedError(
                "InternLM2 with bias: true (biased wqkv and wo): not ported (ROADMAP "
                "queue 1 item 9); the JAX package's remap drops those biases")
        gemma = arch in ("gemma", "gemma2")
        gemma2 = arch == "gemma2"
        granite = arch == "granite"
        # Qwen3-MoE routes like Qwen2-MoE (softmax over all experts, top-k,
        # the norm_topk_prob renormalization) and has no shared expert
        moe = arch in ("qwen2moe", "qwen3moe")
        nh = hf["num_attention_heads"]
        return ModelConfig(
            arch=arch,
            sliding_window_pattern=2 if gemma2 else 1,
            attn_logit_softcap=hf.get("attn_logit_softcapping") if gemma2 else None,
            final_logit_softcap=hf.get("final_logit_softcapping") if gemma2 else None,
            # Granite replaces 1/sqrt(d) by attention_multiplier: the scalar
            # whose ** -0.5 it is
            query_pre_attn_scalar=(hf.get("query_pre_attn_scalar") if gemma2
                                   else hf["attention_multiplier"] ** -2
                                   if granite and hf.get("attention_multiplier") else None),
            post_norms=gemma2,
            residual_multiplier=hf.get("residual_multiplier", 1.0) if granite else 1.0,
            logits_scaling=hf.get("logits_scaling") if granite else None,
            moe_intermediate_size=hf.get("moe_intermediate_size"),
            shared_expert_intermediate_size=(hf.get("shared_expert_intermediate_size", 0)
                                             if arch == "qwen2moe" else 0),
            moe_norm_topk_prob=hf.get("norm_topk_prob", False),
            moe_softmax_before_topk=moe,
            qk_norm=arch in ("qwen3", "qwen3moe"),
            hidden_act=("gelu_tanh" if gemma or "gelu" in
                        hf.get("hidden_act", hf.get("hidden_activation", ""))
                        else "silu"),
            embed_scale=(hf["hidden_size"] ** 0.5 if gemma
                         else hf.get("embedding_multiplier") if granite else None),
            norm_weight_offset=1.0 if gemma else 0.0,
            num_experts=hf.get("num_local_experts", hf.get("num_experts", 0) if moe else 0),
            num_experts_per_tok=hf.get("num_experts_per_tok", 2),
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=nh,
            num_kv_heads=hf.get("num_key_value_heads", nh),
            head_dim=hf.get("head_dim") or hf["hidden_size"] // nh,
            rope_theta=hf.get("rope_theta", 10000.0),
            rope_scaling=_rope_scaling(hf),
            rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
            max_position_embeddings=hf.get("max_position_embeddings", 8192),
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
            qkv_bias=arch in ("qwen2", "qwen2moe"),
            sliding_window=(_qwen_window(hf) if arch in ("qwen2", "qwen3")
                            else hf.get("sliding_window")),
        )

    @staticmethod
    def tiny(**over) -> "ModelConfig":
        """Small config for tests: real structure, CPU-sized."""
        d = dict(vocab_size=512, hidden_size=256, intermediate_size=448,
                 num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
                 rope_theta=10000.0, max_position_embeddings=512)
        d.update(over)
        return ModelConfig(**d)


# model-type fragments of the llama graph's families, in the JAX package's
# order of matching (a type is read by the first fragment it holds)
LLAMA_GRAPH_TYPES = (("qwen3_moe", "qwen3moe"), ("qwen3", "qwen3"), ("qwen2_moe", "qwen2moe"),
                     ("qwen2", "qwen2"), ("mixtral", "mixtral"), ("gemma2", "gemma2"),
                     ("gemma", "gemma"), ("granite", "granite"), ("baichuan", "baichuan"),
                     ("internlm2", "internlm2"), ("llama", "llama"),
                     ("mistral", "llama"), ("phi3", "llama"))
# the archs of the llama graph whose checkpoints carry other key names,
# mapped onto llama keys at load (model_loader/families.py LLAMA_KEY_REMAPS)
REMAP_ARCHS = ("baichuan", "internlm2", "qwen", "exaone", "telechat2")
# model types that hold one of those fragments but name a family whose graph
# the port lacks (the JAX package serves some of them with knobs of its own)
UNPORTED_TYPES = ("gemma3", "paligemma", "recurrent_gemma", "granitemoe", "_vl", "audio",
                  "qwen3_next", "mllama", "llama4", "phi3small", "phi3_v", "phimoe")


def _qwen_window(hf: dict) -> Optional[int]:
    """A dense Qwen2 / Qwen3's window as Hugging Face applies it: none
    unless ``use_sliding_window`` is set, and then only on the layers from
    ``max_window_layers`` on (none where that is past the last layer). The
    JAX package reads ``sliding_window`` whatever the flag says; Qwen2.5-7B
    ships 131072 with the flag off."""
    if not hf.get("use_sliding_window", False) or hf.get("sliding_window") is None:
        return None
    first = hf.get("max_window_layers", hf["num_hidden_layers"])
    if first >= hf["num_hidden_layers"]:
        return None
    if first > 0:
        raise NotImplementedError(
            f"use_sliding_window with max_window_layers={first} < num_hidden_layers="
            f"{hf['num_hidden_layers']}: a window on some layers only is not ported "
            "(ROADMAP queue 1 item 9)")
    return hf["sliding_window"]


def _rope_scaling(hf: dict) -> Optional[dict]:
    """config.json's rope_scaling; a longrope one (Phi-3) also gets the
    top-level ``original_max_position_embeddings`` where it lacks its own,
    as Hugging Face reads it (the JAX package leaves it out, and so scales
    every position by the short factors with no attention factor); a
    dynamic NTK one (InternLM2) gets ``max_position_embeddings`` as its
    original window, where Hugging Face starts scaling the base (the JAX
    package ignores the scaling, which is right only inside that window)."""
    rs = hf.get("rope_scaling")
    kind = rs and rs.get("rope_type", rs.get("type"))
    if (kind in ("longrope", "su") and "original_max_position_embeddings" not in rs
            and "original_max_position_embeddings" in hf):
        rs = {**rs, "original_max_position_embeddings": hf["original_max_position_embeddings"]}
    if kind == "dynamic" and "original_max_position_embeddings" not in rs:
        rs = {**rs, "original_max_position_embeddings": hf.get("max_position_embeddings", 8192)}
    return rs


def _llama_keyed(hf: dict, arch: str, **over) -> ModelConfig:
    """A remap family's config by the llama reader, with ``over`` replacing
    config.json fields (its own names) and ``arch`` set after, as the JAX
    registry's readers do."""
    cfg = ModelConfig.from_hf_config({**hf, **over, "model_type": "llama"})
    return dataclasses.replace(cfg, arch=arch)


def _from_qwen1(hf: dict) -> ModelConfig:
    """Qwen v1 (``QWenLMHeadModel``; the JAX registry's ``_qwen1``): the
    llama graph with the fused c_attn and its bias, multi-head, the halved
    ``intermediate_size`` (config.json gives twice the MLP width), its
    eps in ``layer_norm_epsilon``. Its base is ``rotary_emb_base`` (the JAX
    package reads ``rope_theta``, absent there, and so 10000 whatever the
    checkpoint says); its ``use_dynamic_ntk`` and ``use_logn_attn`` act
    only past ``seq_length``: they are recorded as a dynamic rope_scaling
    of that window (``scaling_window``), and the rope cache ends there
    (``max_position_embeddings`` cut to ``seq_length``). A ``rotary_pct``
    below 1 ropes only that share of each head (its modeling code's
    ``rotary_ndims``; the JAX package ropes the whole head whatever it
    says: ROADMAP §3)."""
    nh = hf["num_attention_heads"]
    seq = hf.get("seq_length", 8192)
    max_pos = hf.get("max_position_embeddings", seq)
    scaled = hf.get("use_dynamic_ntk") or hf.get("use_logn_attn")
    cfg = _llama_keyed(hf, "qwen", num_key_value_heads=nh,
                       intermediate_size=hf["intermediate_size"] // 2,
                       head_dim=hf.get("kv_channels") or hf["hidden_size"] // nh,
                       rms_norm_eps=hf.get("layer_norm_epsilon", 1e-6),
                       rope_theta=hf.get("rotary_emb_base", 10000.0),
                       max_position_embeddings=min(max_pos, seq) if scaled else max_pos)
    pct = hf.get("rotary_pct", 1.0)
    return dataclasses.replace(cfg, qkv_bias=True, rope_scaling=(
        {"type": "dynamic", "original_max_position_embeddings": seq} if scaled else None),
        rotary_dim=None if pct == 1.0 else _rotary_dim(cfg.head_dim, pct))


def _from_exaone(hf: dict) -> ModelConfig:
    """EXAONE (the JAX registry's ``_exaone``): the llama graph under GPT
    key names, its widths under GPT or llama field names."""
    return _llama_keyed(hf, "exaone", hidden_size=hf.get("hidden_size", hf.get("n_embd")),
                        num_hidden_layers=hf.get("num_hidden_layers", hf.get("num_layers")),
                        num_attention_heads=hf.get("num_attention_heads", hf.get("n_head")),
                        rms_norm_eps=hf.get("layer_norm_epsilon", 1e-5))


def _from_telechat2(hf: dict) -> ModelConfig:
    """TeleChat2 (the JAX registry's ``_telechat2``): the llama graph,
    multi-head, ``n_head`` / ``n_layer`` / ``ffn_hidden_size``, its window
    ``seq_length``; the o / down biases come with the checkpoint."""
    nh = hf.get("n_head", hf.get("num_attention_heads"))
    return _llama_keyed(hf, "telechat2", num_attention_heads=nh, num_key_value_heads=nh,
                        num_hidden_layers=hf.get("n_layer", hf.get("num_hidden_layers")),
                        intermediate_size=hf.get("ffn_hidden_size", hf.get("intermediate_size")),
                        rms_norm_eps=hf.get("layer_norm_epsilon", 1e-5),
                        max_position_embeddings=hf.get("seq_length", 8192))


def _from_falcon(hf: dict) -> ModelConfig:
    """Falcon (the JAX package's falcon branch): LayerNorm with biases, the
    fused query_key_value, an exact-gelu MLP of ``ffn_hidden_size``; the
    7B / 40B lineage in parallel blocks with rope (multi-query: one KV head;
    ``new_decoder_architecture``: ``num_kv_heads``), falcon-rw in
    sequential blocks with ALiBi and biases. Where Hugging Face builds
    ``ln_attn`` and ``ln_mlp`` (``new_decoder_architecture`` with
    ``num_ln_in_parallel_attn`` 2, its default there) the MLP reads its own
    norm (``parallel_norms=2``; the JAX package reads ``ln_attn`` only and so
    norms the MLP's input with the attention's). A bf16 checkpoint."""
    nh = hf.get("num_attention_heads", hf.get("n_head"))
    new = bool(hf.get("new_decoder_architecture"))
    parallel = hf.get("parallel_attn", True)
    if new and not parallel:
        raise NotImplementedError("Falcon new_decoder_architecture without parallel_attn "
                                  "(Hugging Face adds the attention output twice there)")
    nkv = hf.get("num_kv_heads", nh) if new else (1 if hf.get("multi_query", True) else nh)
    H = hf["hidden_size"]
    return ModelConfig(
        arch="falcon", norm_type="layernorm", mlp_gated=False, parallel_block=parallel,
        parallel_norms=2 if new and (hf.get("num_ln_in_parallel_attn") or 2) == 2 else 1,
        linear_bias=hf.get("bias", False),
        position_embedding="alibi" if hf.get("alibi") else "rope", hidden_act="gelu",
        vocab_size=hf["vocab_size"], hidden_size=H,
        intermediate_size=hf.get("ffn_hidden_size") or 4 * H,
        num_layers=hf.get("num_hidden_layers", hf.get("n_layer")), num_heads=nh,
        num_kv_heads=nkv, head_dim=H // nh, rope_theta=hf.get("rope_theta", 10000.0),
        max_position_embeddings=hf.get("max_position_embeddings", 2048),
        rms_norm_eps=hf.get("layer_norm_epsilon", 1e-5), quant="none",
        tie_word_embeddings=hf.get("tie_word_embeddings", True))


def _from_jais(hf: dict) -> ModelConfig:
    """JAIS (the JAX package's jais branch): GPT-2's skeleton (LayerNorm
    with biases, Conv1D weights, the fused c_attn) with ALiBi and a gated
    silu MLP; its muP scales ride ``embed_scale`` (``embeddings_scale``),
    ``logits_scaling`` (1 / ``width_scale``) and ``query_pre_attn_scalar``
    (d^2 under ``scale_qk_dot_by_d``: scores scaled by 1/d). Learned
    positions and ``alibi_scaling`` raise. A bf16 checkpoint."""
    if hf.get("position_embedding_type", "alibi") != "alibi":
        raise NotImplementedError("JAIS with learned positions is not ported (ROADMAP "
                                  "queue 1 item 9)")
    if hf.get("alibi_scaling"):
        raise NotImplementedError(f"JAIS alibi_scaling={hf['alibi_scaling']!r} is not ported")
    nh, H = hf["n_head"], hf["n_embd"]
    dh = H // nh
    emb = hf.get("embeddings_scale", hf.get("mup_embeddings_scale", 1.0))
    width = (hf["width_scale"] if "width_scale" in hf
             else hf.get("mup_output_alpha", 1.0) * hf.get("mup_width_scale", 1.0))
    by_d = hf.get("scale_qk_dot_by_d", hf.get("mup_scale_qk_dot_by_d", False))
    return ModelConfig(
        arch="jais", norm_type="layernorm", mlp_gated=True, position_embedding="alibi",
        linear_bias=True, hidden_act="silu",
        embed_scale=emb if emb != 1.0 else None,
        logits_scaling=1.0 / width if width != 1.0 else None,
        query_pre_attn_scalar=dh * dh if by_d else None,
        vocab_size=hf["vocab_size"], hidden_size=H,
        intermediate_size=hf.get("n_inner") or 4 * H, num_layers=hf["n_layer"],
        num_heads=nh, num_kv_heads=nh, head_dim=dh,
        max_position_embeddings=hf.get("n_positions", 2048),
        rms_norm_eps=hf.get("layer_norm_epsilon", 1e-5), quant="none",
        tie_word_embeddings=True)


# (model type, config.json flag or None, why) of the layouts those families
# bring whose graph the port lacks: each raises where its config is read
REFUSED = (
    ("cohere", "use_qk_norm", "Cohere with use_qk_norm (per-head LayerNorms of q and "
     "k; the JAX package raises a ValueError)"),
    ("cohere2", None, "Cohere2 (Command R7B: a sliding window on three layers of four and "
     "rope-free global layers; the JAX registry maps it onto Cohere and ignores both)"),
    ("stablelm", "qk_layernorm", "StableLM with qk_layernorm (per-head LayerNorms of q "
     "and k; the JAX package ignores the flag)"),
    ("stablelm", "use_parallel_residual", "StableLM with use_parallel_residual "
     "(StableLM-2-12B's parallel block; the JAX package ignores the flag)"),
    ("phi", "qk_layernorm", "Phi with qk_layernorm (LayerNorms of q and k; the JAX "
     "package ignores the flag)"),
    ("glm4", None, "GLM-4-0414 (Glm4ForCausalLM: post-attention and post-MLP norms; the "
     "JAX registry maps it onto GLM and drops them)"),
)


def _refuse(mt: str, hf: dict) -> None:
    """Raise for a REFUSED layout, before anything else of its config."""
    for t, flag, why in REFUSED:
        if mt == t and (flag is None or hf.get(flag)):
            raise NotImplementedError(f"{why}: not ported (ROADMAP queue 1 item 9)")


def _rotary_dim(head_dim: int, pct: float) -> int:
    """The rotated width of a head at rotary share ``pct``, even and at least
    2 (the JAX package's formula)."""
    return max(2, int(head_dim * pct)) // 2 * 2


def _act(name: str) -> str:
    """A Hugging Face activation name as ``hidden_act``: gelu_new,
    gelu_fast and gelu_pytorch_tanh are the tanh-approximate gelu (one
    formula under three names); any other name is kept (gelu, silu), and
    ModelConfig refuses one it does not take."""
    return {"gelu_new": "gelu_tanh", "gelu_fast": "gelu_tanh",
            "gelu_pytorch_tanh": "gelu_tanh"}.get(name, name)


def _from_gptj(hf: dict) -> ModelConfig:
    """GPT-J (the JAX package's gptj branch): parallel blocks sharing ln_1,
    the interleaved (gptj) rope over ``rotary_dim``, a gelu_new fc MLP with
    biases, attention without, the head with a bias, untied. A bf16
    checkpoint."""
    nh, H = hf["n_head"], hf["n_embd"]
    dh = H // nh
    return ModelConfig(
        arch="gptj", norm_type="layernorm", mlp_gated=False, parallel_block=True,
        parallel_norms=1, linear_bias=False, lm_head_bias=True, rope_style="gptj",
        hidden_act=_act(hf.get("activation_function", "gelu_new")),
        rotary_dim=hf.get("rotary_dim") or dh, vocab_size=hf["vocab_size"], hidden_size=H,
        intermediate_size=hf.get("n_inner") or 4 * H, num_layers=hf["n_layer"],
        num_heads=nh, num_kv_heads=nh, head_dim=dh, rope_theta=10000.0,
        max_position_embeddings=hf.get("n_positions", 2048),
        rms_norm_eps=hf.get("layer_norm_epsilon", 1e-5), quant="none",
        tie_word_embeddings=hf.get("tie_word_embeddings", False))


def _from_gpt_neox(hf: dict) -> ModelConfig:
    """GPT-NeoX / Pythia (the JAX package's gpt_neox branch): LayerNorms
    with biases, biases everywhere, a non-gated gelu MLP, the neox rope over
    ``rotary_pct`` of each head, ``use_parallel_residual`` blocks whose
    attention and MLP each norm the same residual (``parallel_norms=2``),
    sequential blocks without it; the base from ``rope_theta`` or
    ``rotary_emb_base``. A bf16 checkpoint."""
    nh, H = hf["num_attention_heads"], hf["hidden_size"]
    dh = H // nh
    return ModelConfig(
        arch="gpt_neox", norm_type="layernorm", mlp_gated=False,
        parallel_block=hf.get("use_parallel_residual", True), parallel_norms=2,
        linear_bias=True, hidden_act=_act(hf.get("hidden_act", "gelu")),
        rotary_dim=_rotary_dim(dh, hf.get("rotary_pct", 0.25)), vocab_size=hf["vocab_size"],
        hidden_size=H, intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"], num_heads=nh, num_kv_heads=nh, head_dim=dh,
        rope_theta=hf.get("rope_theta", hf.get("rotary_emb_base", 10000.0)),
        rope_scaling=_rope_scaling(hf),
        max_position_embeddings=hf.get("max_position_embeddings", 2048),
        rms_norm_eps=hf.get("layer_norm_eps", 1e-5), quant="none",
        tie_word_embeddings=hf.get("tie_word_embeddings", False))


def _from_phi(hf: dict) -> ModelConfig:
    """Phi-1 / 1.5 / 2 (the JAX package's phi branch): parallel blocks
    sharing one LayerNorm, the neox rope over ``partial_rotary_factor`` of
    each head, a gelu_new MLP, biases everywhere, the head with a bias,
    untied. A bf16 checkpoint."""
    nh, H = hf["num_attention_heads"], hf["hidden_size"]
    dh = H // nh
    return ModelConfig(
        arch="phi", norm_type="layernorm", mlp_gated=False, parallel_block=True,
        parallel_norms=1, linear_bias=True, lm_head_bias=True,
        hidden_act=_act(hf.get("hidden_act", "gelu_new")),
        rotary_dim=_rotary_dim(dh, hf.get("partial_rotary_factor", 0.5)),
        vocab_size=hf["vocab_size"], hidden_size=H, intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"], num_heads=nh,
        num_kv_heads=hf.get("num_key_value_heads") or nh, head_dim=dh,
        rope_theta=hf.get("rope_theta", 10000.0), rope_scaling=_rope_scaling(hf),
        max_position_embeddings=hf.get("max_position_embeddings", 2048),
        rms_norm_eps=hf.get("layer_norm_eps", 1e-5), quant="none",
        tie_word_embeddings=hf.get("tie_word_embeddings", False))


def _from_stablelm(hf: dict) -> ModelConfig:
    """StableLM (the JAX package's stablelm branch): LayerNorms with
    biases, a gated silu MLP, the neox rope over ``partial_rotary_factor``
    (``rope_pct``) of each head, the qkv bias under ``use_qkv_bias``, GQA.
    A bf16 checkpoint."""
    nh, H = hf["num_attention_heads"], hf["hidden_size"]
    dh = H // nh
    return ModelConfig(
        arch="stablelm", norm_type="layernorm", mlp_gated=True, hidden_act="silu",
        linear_bias=False, qkv_bias=hf.get("use_qkv_bias", False),
        rotary_dim=_rotary_dim(dh, hf.get("partial_rotary_factor", hf.get("rope_pct", 0.25))),
        vocab_size=hf["vocab_size"], hidden_size=H, intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"], num_heads=nh,
        num_kv_heads=hf.get("num_key_value_heads", nh), head_dim=dh,
        rope_theta=hf.get("rope_theta", 10000.0), rope_scaling=_rope_scaling(hf),
        max_position_embeddings=hf.get("max_position_embeddings", 4096),
        rms_norm_eps=hf.get("layer_norm_eps", 1e-5), quant="none",
        tie_word_embeddings=hf.get("tie_word_embeddings", False))


def _from_cohere(hf: dict) -> ModelConfig:
    """Cohere / Command-R (the JAX package's cohere branch): parallel
    blocks sharing one bias-free LayerNorm, the gptj rope over the whole
    head, a gated silu MLP, the qkv bias under ``attention_bias``, the head
    always tied, the final logits times ``logit_scale`` (as
    ``logits_scaling`` = 1 / logit_scale). A bf16 checkpoint."""
    nh, H = hf["num_attention_heads"], hf["hidden_size"]
    scale = hf.get("logit_scale", 1.0)
    return ModelConfig(
        arch="cohere", norm_type="layernorm", mlp_gated=True, parallel_block=True,
        parallel_norms=1, linear_bias=False, qkv_bias=hf.get("attention_bias", False),
        rope_style="gptj", hidden_act="silu",
        logits_scaling=(1.0 / scale) if scale != 1.0 else None,
        vocab_size=hf["vocab_size"], hidden_size=H, intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"], num_heads=nh,
        num_kv_heads=hf.get("num_key_value_heads", nh), head_dim=H // nh,
        rope_theta=hf.get("rope_theta", 10000.0), rope_scaling=_rope_scaling(hf),
        max_position_embeddings=hf.get("max_position_embeddings", 8192),
        rms_norm_eps=hf.get("layer_norm_eps", 1e-5), quant="none", tie_word_embeddings=True)


def _from_glm(hf: dict) -> ModelConfig:
    """GLM-4 (``GlmForCausalLM``; the JAX registry's ``_glm``): the llama
    graph with the qkv bias (``attention_bias``), the gptj rope over
    ``partial_rotary_factor`` of each head, the fused gate_up_proj
    (``load_hf_float``'s phi-3 path), a bf16 checkpoint with a bf16 head."""
    H, nh = hf["hidden_size"], hf["num_attention_heads"]
    hd = hf.get("head_dim") or H // nh
    return ModelConfig(
        arch="glm", vocab_size=hf["vocab_size"], hidden_size=H,
        intermediate_size=hf["intermediate_size"], num_layers=hf["num_hidden_layers"],
        num_heads=nh, num_kv_heads=hf.get("num_key_value_heads", nh), head_dim=hd,
        rope_theta=hf.get("rope_theta", 10000.0), rope_scaling=_rope_scaling(hf),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
        max_position_embeddings=hf.get("max_position_embeddings", 8192),
        rotary_dim=_rotary_dim(hd, hf.get("partial_rotary_factor", 0.5)), rope_style="gptj",
        qkv_bias=hf.get("attention_bias", True),
        tie_word_embeddings=hf.get("tie_word_embeddings", False), quant="none",
        lm_head_quant="bf16")


def _from_helium(hf: dict) -> ModelConfig:
    """Helium (kyutai; the JAX registry's ``_helium``): the llama graph
    with the gptj rope."""
    return dataclasses.replace(ModelConfig.from_hf_config({**hf, "model_type": "llama"}),
                               arch="helium", rope_style="gptj")


def _from_deepseek(hf: dict) -> ModelConfig:
    """DeepSeek-MoE V1: Llama attention; an MoE MLP on every layer past the
    dense prefix (first_k_dense_replace), softmax-then-top-k routing and
    ungated shared experts of n_shared_experts * moe_intermediate_size
    (``qspec_tpu/config.py``'s deepseek branch, with its refusal)."""
    if hf.get("moe_layer_freq", 1) != 1:
        raise ValueError("deepseek moe_layer_freq != 1 unsupported")
    nh = hf["num_attention_heads"]
    return ModelConfig(
        arch="deepseek", num_experts=hf["n_routed_experts"],
        num_experts_per_tok=hf["num_experts_per_tok"],
        moe_intermediate_size=hf["moe_intermediate_size"],
        shared_expert_intermediate_size=(hf.get("n_shared_experts", 0) or 0)
        * hf["moe_intermediate_size"],
        shared_expert_gated=False, first_k_dense=hf.get("first_k_dense_replace", 0),
        moe_softmax_before_topk=True, moe_norm_topk_prob=hf.get("norm_topk_prob", False),
        vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"], num_layers=hf["num_hidden_layers"],
        num_heads=nh, num_kv_heads=hf.get("num_key_value_heads", nh),
        head_dim=hf["hidden_size"] // nh, rope_theta=hf.get("rope_theta", 10000.0),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
        max_position_embeddings=hf.get("max_position_embeddings", 4096),
        tie_word_embeddings=hf.get("tie_word_embeddings", False))


def _from_deepseek_v2(hf: dict) -> ModelConfig:
    """DeepSeek-V2 / V2-Lite (``qspec_tpu/config.py``'s deepseek_v2 branch,
    with both its refusals): multi-head latent attention (``kv_lora_rank``,
    ``q_lora_rank`` or a direct q, the decoupled rope over
    ``qk_rope_head_dim``) over DeepSeek-MoE's layout with
    ``routed_scaling_factor``; a bf16 checkpoint. Group-limited routing
    (``topk_method`` other than greedy) and a yarn ``rope_scaling`` raise, as
    they do there, so neither package serves a published DeepSeek-V2
    config.json as it is (ROADMAP §3); another rope scaling is read as
    Hugging Face reads it (``make_rope_cache`` raises for a type it lacks),
    where the JAX package drops it."""
    if hf.get("topk_method", "greedy") not in ("greedy", None):
        raise ValueError(f"deepseek-v2 group-limited routing unsupported (topk_method="
                         f"{hf['topk_method']!r})")
    if (hf.get("rope_scaling") or {}).get("type") == "yarn":
        raise ValueError("deepseek-v2 yarn rope scaling unsupported")
    nh = hf["num_attention_heads"]
    moe_i = hf.get("moe_intermediate_size")
    return ModelConfig(
        arch="deepseek_v2", attention_type="mla", kv_lora_rank=hf["kv_lora_rank"],
        q_lora_rank=hf.get("q_lora_rank"), qk_nope_head_dim=hf["qk_nope_head_dim"],
        qk_rope_head_dim=hf["qk_rope_head_dim"], v_head_dim=hf["v_head_dim"],
        rotary_dim=hf["qk_rope_head_dim"],
        routed_scaling_factor=hf.get("routed_scaling_factor", 1.0),
        num_experts=hf.get("n_routed_experts", 0) or 0,
        num_experts_per_tok=hf.get("num_experts_per_tok", 2), moe_intermediate_size=moe_i,
        shared_expert_intermediate_size=(hf.get("n_shared_experts", 0) or 0) * (moe_i or 0),
        shared_expert_gated=False, first_k_dense=hf.get("first_k_dense_replace", 0),
        moe_softmax_before_topk=True, moe_norm_topk_prob=hf.get("norm_topk_prob", False),
        vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"], num_layers=hf["num_hidden_layers"],
        num_heads=nh, num_kv_heads=nh, head_dim=hf["qk_nope_head_dim"] + hf["qk_rope_head_dim"],
        quant="none", rope_theta=hf.get("rope_theta", 10000.0),
        rope_scaling=_rope_scaling(hf), rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
        max_position_embeddings=hf.get("max_position_embeddings", 4096),
        tie_word_embeddings=hf.get("tie_word_embeddings", False))


def _from_bloom(hf: dict) -> ModelConfig:
    """BLOOM: ALiBi, LayerNorm with biases, a non-gated tanh-gelu MLP of
    width 4H, the head-interleaved fused query_key_value (de-interleaved by
    model_loader.families.convert_bloom), an embedding LayerNorm, the tied
    head; a bf16 checkpoint (``qspec_tpu/config.py``'s bloom branch)."""
    nh = hf["n_head"]
    return ModelConfig(
        arch="bloom", norm_type="layernorm", mlp_gated=False,
        position_embedding="alibi", linear_bias=True, hidden_act="gelu_tanh",
        vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
        intermediate_size=4 * hf["hidden_size"], num_layers=hf["n_layer"],
        num_heads=nh, num_kv_heads=nh, head_dim=hf["hidden_size"] // nh,
        max_position_embeddings=hf.get("seq_length", 8192),
        rms_norm_eps=hf.get("layer_norm_epsilon", 1e-5), quant="none",
        tie_word_embeddings=True)


def _from_mpt(hf: dict) -> ModelConfig:
    """MPT: ALiBi, LayerNorm (bias-free under no_bias), the fused Wqkv in
    q|k|v order, a non-gated exact-gelu MLP of expansion_ratio * d_model,
    the tied head, an optional clip_qkv; a bf16 checkpoint
    (``qspec_tpu/config.py``'s mpt branch, with its refusals)."""
    ac = hf.get("attn_config", {}) or {}
    if not ac.get("alibi", True):
        raise ValueError("MPT without ALiBi (learned positions) is not supported")
    if ac.get("qk_ln"):
        raise ValueError("MPT qk_ln is not supported")
    nh = hf["n_heads"]
    return ModelConfig(
        arch="mpt", norm_type="layernorm", mlp_gated=False,
        position_embedding="alibi", linear_bias=not hf.get("no_bias", True),
        clip_qkv=ac.get("clip_qkv"), hidden_act="gelu",
        vocab_size=hf["vocab_size"], hidden_size=hf["d_model"],
        intermediate_size=int(hf.get("expansion_ratio", 4) * hf["d_model"]),
        num_layers=hf["n_layers"], num_heads=nh,
        num_kv_heads=ac.get("kv_n_heads", nh) or nh, head_dim=hf["d_model"] // nh,
        max_position_embeddings=hf.get("max_seq_len", 2048),
        rms_norm_eps=hf.get("layer_norm_epsilon", 1e-5), quant="none",
        tie_word_embeddings=True)


# bigscience/bloom-7b1's config.json (Hugging Face), the fields the port reads
BLOOM_7B1_HF = {
    "architectures": ["BloomForCausalLM"], "model_type": "bloom",
    "vocab_size": 250880, "hidden_size": 4096, "n_layer": 30, "n_head": 32,
    "layer_norm_epsilon": 1e-5,
}
# mosaicml/mpt-7b's config.json (Hugging Face), the fields the port reads
MPT_7B_HF = {
    "architectures": ["MPTForCausalLM"], "model_type": "mpt",
    "d_model": 4096, "n_heads": 32, "n_layers": 32, "expansion_ratio": 4,
    "max_seq_len": 2048, "vocab_size": 50432, "no_bias": True,
    "attn_config": {"alibi": True, "clip_qkv": None, "qk_ln": False},
}

# meta-llama/Meta-Llama-3-8B's config.json (Hugging Face), the fields the
# port reads: ModelConfig.llama3_8b()'s widths
LLAMA3_8B_HF = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama",
    "vocab_size": 128256, "hidden_size": 4096, "intermediate_size": 14336,
    "num_hidden_layers": 32, "num_attention_heads": 32, "num_key_value_heads": 8,
    "rope_theta": 500000.0, "rms_norm_eps": 1e-5, "max_position_embeddings": 8192,
    "hidden_act": "silu", "tie_word_embeddings": False,
}

# google/gemma-2-9b's config.json (Hugging Face), the fields the port reads
GEMMA2_9B_HF = {
    "architectures": ["Gemma2ForCausalLM"], "model_type": "gemma2",
    "vocab_size": 256000, "hidden_size": 3584, "intermediate_size": 14336,
    "num_hidden_layers": 42, "num_attention_heads": 16, "num_key_value_heads": 8,
    "head_dim": 256, "query_pre_attn_scalar": 256, "sliding_window": 4096,
    "attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0,
    "rms_norm_eps": 1e-6, "rope_theta": 10000.0, "max_position_embeddings": 8192,
    "hidden_activation": "gelu_pytorch_tanh", "tie_word_embeddings": True,
}

# the published config.json fields of the multi-head latent attention
# models the port reads, each without its rope_scaling: DeepSeek-V2-Lite's
# and DeepSeek-V3's are yarn, which both packages refuse; MiniCPM3-4B's is a
# longrope whose 16 short and 16 long factors are not in the repository
DEEPSEEK_V2_LITE_HF = {
    "architectures": ["DeepseekV2ForCausalLM"], "model_type": "deepseek_v2",
    "vocab_size": 102400, "hidden_size": 2048, "intermediate_size": 10944,
    "moe_intermediate_size": 1408, "num_hidden_layers": 27, "num_attention_heads": 16,
    "num_key_value_heads": 16, "n_routed_experts": 64, "n_shared_experts": 2,
    "num_experts_per_tok": 6, "first_k_dense_replace": 1, "moe_layer_freq": 1,
    "kv_lora_rank": 512, "q_lora_rank": None, "qk_nope_head_dim": 128,
    "qk_rope_head_dim": 64, "v_head_dim": 128, "routed_scaling_factor": 1.0,
    "topk_method": "greedy", "norm_topk_prob": False, "scoring_func": "softmax",
    "max_position_embeddings": 163840, "rms_norm_eps": 1e-6, "rope_theta": 10000,
    "tie_word_embeddings": False,
}
DEEPSEEK_V3_HF = {
    "architectures": ["DeepseekV3ForCausalLM"], "model_type": "deepseek_v3",
    "vocab_size": 129280, "hidden_size": 7168, "intermediate_size": 18432,
    "moe_intermediate_size": 2048, "num_hidden_layers": 61, "num_attention_heads": 128,
    "num_key_value_heads": 128, "n_routed_experts": 256, "n_shared_experts": 1,
    "num_experts_per_tok": 8, "n_group": 8, "topk_group": 4, "first_k_dense_replace": 3,
    "moe_layer_freq": 1, "kv_lora_rank": 512, "q_lora_rank": 1536, "qk_nope_head_dim": 128,
    "qk_rope_head_dim": 64, "v_head_dim": 128, "routed_scaling_factor": 2.5,
    "topk_method": "noaux_tc", "norm_topk_prob": True, "scoring_func": "sigmoid",
    "max_position_embeddings": 163840, "rms_norm_eps": 1e-6, "rope_theta": 10000,
    "tie_word_embeddings": False,
}
MINICPM3_4B_HF = {
    "architectures": ["MiniCPM3ForCausalLM"], "model_type": "minicpm3",
    "vocab_size": 73448, "hidden_size": 2560, "intermediate_size": 6400,
    "num_hidden_layers": 62, "num_attention_heads": 40, "num_key_value_heads": 40,
    "q_lora_rank": 768, "kv_lora_rank": 256, "qk_nope_head_dim": 64, "qk_rope_head_dim": 32,
    "v_head_dim": 64, "max_position_embeddings": 32768, "rms_norm_eps": 1e-5,
    "rope_theta": 10000.0, "scale_emb": 12, "scale_depth": 1.4, "dim_model_base": 256,
    "hidden_act": "silu", "tie_word_embeddings": True,
}


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Paged KV cache sizing."""

    page_size: int = 128
    num_pages: Optional[int] = None      # None -> derive from free memory
    # "bfloat16" | "int8" | "fp8_e4m3" | "fp8_e5m2" (ops/kv_cache.py)
    kv_cache_dtype: str = "bfloat16"
    enable_prefix_caching: bool = True
    gpu_memory_utilization: float = 0.9
    # host RAM for swap-mode preemption (SchedulerConfig.preemption_mode =
    # "swap"): a preempted sequence's KV pages park there
    swap_space_gb: float = 4.0


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Continuous-batching knobs."""

    max_num_seqs: int = 8
    max_num_batched_tokens: int = 2048
    max_model_len: int = 4096
    enable_chunked_prefill: bool = True
    prefill_chunk_size: int = 512
    # co-schedule running decodes with prefill chunks
    mix_decode_with_prefill: bool = True
    # "recompute" re-prefills preempted sequences; "swap" parks their KV
    # pages in host RAM (CacheConfig.swap_space_gb) and scatters them back
    # on resume, falling back to recompute when that is full
    preemption_mode: str = "recompute"
    # batch and token buckets: every step runs at a bucketed shape, so the
    # QSpec run and its AR oracle see identical shapes
    decode_batch_buckets: tuple = (1, 2, 4, 8, 16, 32)
    prefill_token_buckets: tuple = (128, 256, 512, 1024, 2048)


ACCEPTANCE_METHODS = ("rejection_sampler", "typical_acceptance_sampler")


@dataclasses.dataclass(frozen=True)
class SpeculativeConfig:
    """Speculative decoding: QSpec over shared weights or with a separate
    draft model, Medusa heads, MLPSpeculator, EAGLE, or n-gram prompt
    lookup."""

    num_speculative_tokens: int = 3
    # draft scheme; verify is always w4a16. "w4a4" is the QSpec method;
    # "w4a16" drafts with the target's own arithmetic (the only shared-weights
    # draft of a w4g checkpoint, usually under draft_kv_window)
    draft_scheme: str = "w4a4"
    # complete draft+verify rounds per engine step
    rounds_per_step: int = 1
    # disable speculation at or above this batch size
    disable_by_batch_size: Optional[int] = None
    # "qspec": shared-weights draft; "qspec_null": the same rounds with the
    # proposals nulled, which emit exactly the greedy AR tokens (the oracle);
    # "medusa": trained heads (params["medusa"], spec_decode/medusa.py) that
    # read the verify pass's hidden state, no draft forward and no draft
    # cache; "medusa_null": the Medusa rounds with the proposals nulled (its
    # oracle, and MLPSpeculator's); "mlp_speculator": MLPSpeculator's
    # recurrent heads (params["mlp_spec"], spec_decode/mlp_speculator.py) in
    # the same rounds; "eagle": a one-layer draft net (params["eagle"],
    # spec_decode/eagle.py) over the target's hidden states with its own
    # one-layer KV pool (greedy AR is its oracle); "ngram": prompt lookup
    # over the sequence's own tokens, matched
    # on the device (ops/ngram.py), no draft forward and no draft cache (the
    # proposer of a bf16 checkpoint, which has no int4 weights to draft
    # with); "null": the n-gram rounds with the proposals nulled (its oracle)
    method: str = "qspec"
    # sliding-window cap on the shared-weights draft's attention (MagicDec):
    # the draft reads only the last `draft_kv_window` KV positions and keeps
    # its KV in a small per-sequence ring of pages; verification stays
    # full-context, so only acceptance depends on it. None = full context.
    draft_kv_window: Optional[int] = None
    # Medusa candidate tree: a tuple of paths in Medusa-choices format, e.g.
    # ((0,), (1,), (0, 0), ...) (spec_decode/medusa_tree.py, DEFAULT_TREE);
    # each round verifies the whole tree in one pass under the tree mask and
    # walks it. None: one top-1 chain of k proposals per round.
    medusa_tree: Optional[tuple] = None
    # n-gram prompt lookup: the longest tail n-gram, n in [min, max], that
    # occurred before proposes the k tokens after its latest occurrence
    ngram_prompt_lookup_max: int = 4
    ngram_prompt_lookup_min: int = 1
    # a SEPARATE draft model (methods "qspec" / "qspec_null"): a smaller LM
    # with its own parameters (passed to the engine as draft_params) and its
    # own KV pool over the target's page ids, which must share the target's
    # vocabulary; a quant="w4" draft runs ``draft_scheme``, a float one the
    # bf16 scheme. None: the shared-weights draft.
    draft_model: Optional[ModelConfig] = None
    # TIMING ONLY: every QSpec round emits exactly min(force_accept_len + 1,
    # k + 1) tokens whatever the verify decided (the slots past the real
    # acceptance hold token 0). All device work still runs, so the wall time
    # is a round's at that acceptance; the tokens are not the target's
    # greedy continuation, except at 0, where a round emits the verify's
    # first token, the AR token. None: the real acceptance.
    force_accept_len: Optional[int] = None
    # the QSpec rounds' acceptance rule: "rejection_sampler" (lossless) or
    # "typical_acceptance_sampler" (lossy: accept a draft whose target
    # probability passes an entropy-scaled threshold, else emit the argmax)
    acceptance_method: str = "rejection_sampler"

    def __post_init__(self):
        if self.acceptance_method not in ACCEPTANCE_METHODS:
            raise ValueError(f"acceptance_method {self.acceptance_method!r}: one of "
                             f"{ACCEPTANCE_METHODS}")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    cache: CacheConfig = dataclasses.field(default_factory=CacheConfig)
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    speculative: Optional[SpeculativeConfig] = None

    def __post_init__(self):
        window = self.model.scaling_window
        if window is not None and self.scheduler.max_model_len > window:
            raise NotImplementedError(
                f"max_model_len={self.scheduler.max_model_len} past the model's scaling "
                f"window of {window} positions: its dynamic NTK rope (rope_scaling "
                "'dynamic', Qwen v1's use_dynamic_ntk) and Qwen v1's logn attention "
                "act past it, and the port serves the plain rope and attention they "
                "leave inside it")
