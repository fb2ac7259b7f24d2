"""The benchmark's own tests (CPU; ``cuda``-marked ones run on the card):
``python -m pytest perfbench/tests`` from the repository's root."""
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import pytest  # noqa: E402

# Mistral-shaped models small enough for the CPU, and traffic cut to match.
# The training one is a little wider, so that its sound bf16 readings sit
# under the cell's limits as the full-size model's do.
TINY_MODEL = {"hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 4,
              "num_key_value_heads": 2, "head_dim": 16, "vocab_size": 256, "max_position_embeddings": 256}
TINY_TRAIN = {"hidden_size": 128, "intermediate_size": 256, "num_hidden_layers": 2, "num_attention_heads": 4,
              "num_key_value_heads": 2, "head_dim": 32, "vocab_size": 512, "max_position_embeddings": 256}


def tiny_cell(name: str):
    """The cell as BENCHMARK.json has it (its entry, limits and metrics),
    with the model and traffic cut to a size the CPU runs in seconds."""
    from perfbench import harness

    cell = harness.load_cell(name)
    t = cell.traffic
    cell.config.update(TINY_MODEL if "engine" in t else TINY_TRAIN)
    if "engine" in t:
        t["engine"].update(page_size=16, max_slots=8, max_seq=256, total_pages=8 * 9 + 1,
                           prefill_buckets=[32, 64, 128])
        t["warmup_buckets"] = [32, 64, 128]
        t["prompt_len"].update(min=20, max=100)
        if "median" in t["prompt_len"]:
            t["prompt_len"]["median"] = 48
        t["output_len"].update(min=4, max=16)
        if "first_wave_output_len" in t:
            t["first_wave_output_len"].update(min=2, max=16)
            t.update(pool=2000, backlog=8)
        if "arrivals" in t:
            t["arrivals"]["rate_per_s"] = 6
        t["judge"]["min_tokens"] = 24
    else:
        t.update(batch=8, seq=128, reference_rows=4)
    return cell


@pytest.fixture
def tiny():
    return tiny_cell
