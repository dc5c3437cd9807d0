"""The federated core of the port: plan, FVN, CFMQ, the FedAvg engine, tasks."""
