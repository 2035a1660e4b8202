"""Smoke-size cells for the CPU tests: the two configurations' blocks
(GQA with an untied head, MHA with a tied one) at widths a test can run,
their exchange plans as the program derives them."""

OPT = {"name": "adamw", "lr": 1e-3, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
       "weight_decay": 0.1}

CONFS = {
    "gqa": {"registry": "yi-9b", "hidden_size": 64, "num_hidden_layers": 2,
            "num_attention_heads": 4, "num_key_value_heads": 2,
            "intermediate_size": 128, "vocab_size": 256,
            "tie_word_embeddings": False, "rms_norm_eps": 1e-5,
            "rope_theta": 10000.0, "remat": True, "optimizer": OPT,
            "exchange": {"rows": 5, "buckets": [
                {"d": 70144, "k": 280, "width": 256, "hash_seed": 0},
                {"d": 37888, "k": 152, "width": 256, "hash_seed": 1}]}},
    "mha": {"registry": "minicpm-2b", "hidden_size": 60,
            "num_hidden_layers": 2, "num_attention_heads": 6,
            "num_key_value_heads": 6, "intermediate_size": 96,
            "vocab_size": 250, "tie_word_embeddings": True,
            "rms_norm_eps": 1e-5, "rope_theta": 10000.0, "remat": True,
            "optimizer": OPT,
            "exchange": {"rows": 5, "buckets": [
                {"d": 47616, "k": 190, "width": 256, "hash_seed": 0},
                {"d": 32768, "k": 131, "width": 256, "hash_seed": 1}]}},
}

TRAFFIC = {"workers": 2, "seqs_per_worker": 2, "seq_len": 16,
           "mesh": False, "allreduce_mode": "psum", "profile_steps": 2}

# loose enough for the CPU's float32 sums, tight enough for every fault
LIMITS = {"loss_gap": {"limit": 1e-5}, "grad_gap": {"limit": 1e-3},
          "change_gap": {"limit": 1e-3}}


def cell(kind: str, **traffic) -> dict:
    return {"name": f"smoke-{kind}", "chips": 1, "conf": CONFS[kind],
            "traffic": {**TRAFFIC, **traffic}, "limits": LIMITS,
            "end_to_end": [], "per_layer": []}
