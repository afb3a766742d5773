from .metric import acc, auc, mae, max, min, mse, rmse, sum  # noqa: F401,A004
