"""Decision-provenance reason codes written by the cycle epilogue.

A copy of the constants of cook_tpu/obs/decisions.py:25-39; they MUST
mirror the torch.where ladder in ops/cycle.py. 0 is the pad value for
queue positions past the valid prefix.
"""
PAD = 0
MATCHED = 1          # amt = host id it matched
NO_HOST_FIT = 2      # considerable, but no host had room / constraints
RANK_CUTOFF = 3      # amt = DRU-rank ordinal vs the considerable cap
QUOTA_MEM = 4        # amt = mem overage (requested cum - quota)
QUOTA_CPUS = 5       # amt = cpus overage
QUOTA_COUNT = 6      # amt = job-count overage
INVALID = 7          # queue slot held no valid pending job

CODE_NAMES = {
    PAD: "pad", MATCHED: "matched", NO_HOST_FIT: "no_host_fit",
    RANK_CUTOFF: "rank_cutoff", QUOTA_MEM: "quota_mem",
    QUOTA_CPUS: "quota_cpus", QUOTA_COUNT: "quota_count",
    INVALID: "invalid",
}
