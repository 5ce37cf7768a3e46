"""The cells' files at debug widths, for CPU tests: the same drivers,
references and readers, on configurations a test run can hold."""

import contextlib
import copy

from benchmark.harness import core


def agent_files(cell: str = "ds7b_vqa_serve"):
    f = core.cell_files(cell)
    c = copy.deepcopy(f["config"])
    c.update(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=4, vocab_size=40000)
    c["vision"].update(image_size=56, width=128, layers=2, heads=4,
                       mlp_ratio=2.0, n_queries=16, output_dim=128)
    c["agent"].update(num_img_in_tokens=4, num_img_out_tokens=4, vit_dim=128,
                      resampler_heads=4)
    f["config"] = c
    cell, mix = copy.deepcopy(f["cell"]), copy.deepcopy(f["mix"])
    cell["engine"].update(slots=4, max_new_tokens=24,
                          prompt_buckets=[64, 128])
    # limits read at these widths (the cell's own are set at its widths)
    cell["check"]["token_gap"] = 0.05
    sizes = mix["sizes"]
    sizes["output_tokens"].update(median=8, min=2, max=24)
    text = mix["text"]["size"]
    if text == "question_tokens":
        sizes[text].update(median=8, min=2, max=40)
    else:
        sizes[text].update(min=20, max=100)
    f["cell"], f["mix"] = cell, mix
    return f


def sdxl_files():
    f = core.cell_files("sdxl_t2i_1024")
    c = copy.deepcopy(f["config"])
    c.update(block_out_channels=[32, 64],
             down_block_types=["DownBlock2D", "CrossAttnDownBlock2D"],
             transformer_layers_per_block=[1, 1], attention_head_dim=[1, 2],
             cross_attention_dim=64, addition_time_embed_dim=32,
             projection_class_embeddings_input_dim=32 * 6 + 32,
             norm_num_groups=8)
    c["vae"].update(block_out_channels=[16, 32], norm_num_groups=8)
    c["resampler"].update(dim=64, depth=1, dim_head=16, heads=4,
                          num_queries=4, embedding_dim=128, output1_dim=32,
                          output2_dim=32)
    c["sampler"].update(height=64, width=64, num_inference_steps=4)
    # the adapter's CFG negative is a 448^2 zeros image at any width
    c["vision"].update(image_size=448, width=128, layers=2, heads=4,
                       mlp_ratio=2.0, n_queries=16, output_dim=128)
    f["config"] = c
    f["cell"] = copy.deepcopy(f["cell"])
    f["cell"]["check"].update(steps=3, cond=0.05, eps=0.3, step=1e-4,
                              image=1e-3)
    return f


@contextlib.contextmanager
def few_threads(n: int = 2):
    """Torch on ``n`` of the CPU's threads: test processes side by side
    would otherwise each take every core (and each driver thread its own
    team of them), and a serving run's last requests would come more than
    a minute late."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def run(files, seed: int = 2**31 + 11, seconds: float = 2.0, trace=0,
        rate=None):
    """core.run on the CPU: everything of a run after the look for a
    chip."""
    import argparse
    import time

    import torch

    args = argparse.Namespace(seed=seed, seconds=seconds, trace=trace,
                              rate=rate)
    spec = core.declared(files["name"])
    with few_threads():
        return core.run(files, spec, args, torch.device("cpu"), 1,
                        time.perf_counter())
