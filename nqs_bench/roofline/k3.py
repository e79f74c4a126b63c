"""K3, the min-sum check-to-variable update (`csrc/bp_c2v.cu`): one launch a
check pass of `ldpc._bp_slots`, over the messages (w_max, n_chk, S) and the
syndrome signs (n_chk, S) in the tier's dtype.

A tier of n iterations makes n + 1 launches (n message updates, then the
beliefs' pass). The BB step runs two tiers: the fast one on every shot in
bfloat16, the retry on its capacity min(S, max(S // retry_cap_divisor, 64))
in float32, whatever share of it holds unconverged shots. No arithmetic is
counted (compares and a multiply an edge); bytes, each once: the messages in
and out and the signs in. A message is counted on each of the DEM's edges
(`dem.n_edges`, 5283 in bb-gross), which is what min-sum needs, and not on
each slot of K3's padded layout (w_max x n_chk, 7488 there): a layout with
fewer slots reads the same bound, and its roofline rises as it runs faster."""


def launch_bytes(n_edges: int, n_chk: int, S: int, itemsize: int) -> float:
    return float(itemsize) * (2 * n_edges * S + n_chk * S)


def retry_rows(shots: int, retry_cap_divisor: int) -> int:
    return min(shots, max(shots // retry_cap_divisor, 64))


def launches(config: dict) -> int:
    st = config["decoder"]
    return int(st["fast_iters"]) + 1 + int(st["retry_iters"]) + 1


def step_bytes(config: dict, shots: int) -> float:
    """K3's bytes in one step of `shots` shots of a BB configuration."""
    st, dem = config["decoder"], config["dem"]
    e, m = int(dem["n_edges"]), int(dem["n_detectors"])
    fast = (int(st["fast_iters"]) + 1) * launch_bytes(e, m, shots, 2)
    rows = retry_rows(shots, int(st["retry_cap_divisor"]))
    return fast + (int(st["retry_iters"]) + 1) * launch_bytes(e, m, rows, 4)
