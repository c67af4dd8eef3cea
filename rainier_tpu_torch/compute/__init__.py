from . import (bounds, cholesky, compiler, emit_cuda, evaluator, interp,
               real, vec)
from .evaluator import Evaluator
from .real import (Real, Constant, Parameter, VectorParameter, Column,
                   IntColumn, MatColumn, const, to_real, parameter,
                   vector_parameter, sum_, log_sum_exp, eq, lt, gt, lte,
                   gte, compare, lookup, zero, one, two, neg_one, pi,
                   infinity, neg_infinity)
from .vec import Vec
from .compiler import CompiledDensity

__all__ = [
    "bounds", "cholesky", "compiler", "emit_cuda", "evaluator", "interp",
    "real", "vec", "Evaluator", "Real", "Constant", "Parameter", "VectorParameter", "Column", "IntColumn",
    "MatColumn", "const", "to_real", "parameter", "vector_parameter",
    "sum_", "log_sum_exp", "eq", "lt", "gt", "lte", "gte", "compare",
    "lookup", "zero", "one", "two", "neg_one", "pi", "infinity",
    "neg_infinity", "Vec", "CompiledDensity",
]
