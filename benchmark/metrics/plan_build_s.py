"""Host seconds of the plan build in set-up (`make_plan`, or
`partition_row_plans` for the shards), timed by the entry."""


def read(facts):
    return facts.get("plan_build_s")
