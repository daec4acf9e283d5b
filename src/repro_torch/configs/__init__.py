"""Model configs of the port: the Mirage agent's foundation trunk and the
payload models it serves and trains (Mamba2-1.3B, TinyLlama-1.1B,
Qwen1.5-4B, Qwen1.5-MoE-A2.7B, Gemma-3-27B, DeepSeek-V2-236B, the hybrid
Zamba2-7B, Command-R 35B, the vision-language Qwen2-VL-7B and the encoder
HuBERT X-Large)."""
