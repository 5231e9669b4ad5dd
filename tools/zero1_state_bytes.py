"""Train-state bytes a card for each LM train config over a data mesh,
with and without ZeRO-1, computed from the port's specs (no card needed).

    PYTHONPATH=src python tools/zero1_state_bytes.py [--cards 4]

Builds every LM architecture's ``train_4k`` cell on the ``meta`` device
(``registry.build_cell``, with and without ``zero1``), lays each leaf's
spec over a ``(cards, 1)`` ``("data", "model")`` mesh
(``sharding.split_of``) and counts, per card: the float32 master, ``m``
and ``v`` (a split leaf's share, a replicated leaf whole), the bf16
compute copy that ZeRO-1's ``compute_cast`` gathers (whole on every
card), and the gradients the step holds: without ZeRO-1 the float32
accumulator (whole); with it the float32 accumulator in the master's
split and one microbatch's bf16 gradients (whole). Activations are not
counted. Prints a markdown table, then one JSON line a row.
"""
from __future__ import annotations

import argparse
import json
import math

GB = 1e9
CARD_BYTES = 80e9  # one H100's HBM (NVIDIA data sheet)


def rows(cards: int) -> list[dict]:
    from repro_torch.distributed import make_mesh
    from repro_torch.distributed.api import resolved_spec
    from repro_torch.distributed.sharding import split_of
    from repro_torch.models import registry

    mesh = make_mesh((cards, 1), ("data", "model"), devices=["meta"] * cards)
    out = []
    for arch in registry.list_archs():
        if registry.family_of(arch) != "lm":
            continue
        for zero1 in (False, True):
            cell = registry.build_cell(arch, "train_4k", mesh_dp=cards,
                                       overrides={"zero1": zero1})
            state, specs = cell.args[0], cell.arg_specs[0]["params"]
            master = full = 0
            for k, leaf in state["opt"]["m"].items():
                n = math.prod(leaf.shape)
                split = split_of(resolved_spec(specs[k], mesh), mesh)
                master += 4 * n // (cards if split else 1)
                full += n
            compute = 2 * full if zero1 else 0
            grads = master + 2 * full if zero1 else 4 * full
            total = 3 * master + compute + grads
            out.append({"arch": arch, "zero1": zero1, "cards": cards,
                        "params": full, "master": master, "m": master,
                        "v": master, "compute_copy": compute,
                        "gradients": grads, "total": total,
                        "fits_80GB_before_activations":
                            total < CARD_BYTES})
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=4)
    args = ap.parse_args(argv)
    table = rows(args.cards)
    print(f"| arch | ZeRO-1 | master GB | m GB | v GB | bf16 compute copy "
          f"GB | gradients GB | total GB a card ({args.cards} cards) |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- |")
    for r in table:
        print(f"| {r['arch']} | {'yes' if r['zero1'] else 'no'} | "
              f"{r['master'] / GB:.1f} | {r['m'] / GB:.1f} | "
              f"{r['v'] / GB:.1f} | {r['compute_copy'] / GB:.1f} | "
              f"{r['gradients'] / GB:.1f} | {r['total'] / GB:.1f} |")
    for r in table:
        print(json.dumps(r))


if __name__ == "__main__":
    main()
