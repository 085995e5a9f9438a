"""Compatibility facades for code written against the reference's APIs."""

from .opt_api import (  # noqa: F401
    Opt_NewState,
    Opt_ProblemDefine,
    Opt_ProblemPlan,
    Opt_SetSolverParameter,
    Opt_ProblemSolve,
    Opt_ProblemInit,
    Opt_ProblemStep,
    Opt_ProblemCurrentCost,
    Opt_PlanFree,
    Opt_ProblemDelete,
)
