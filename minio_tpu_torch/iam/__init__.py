"""IAM, the port of minio_tpu/iam/: users, groups, service accounts,
canned and custom policies, STS (reference cmd/iam.go + pkg/iam/policy +
cmd/sts-handlers.go)."""
from .policy import Policy, Statement, policy_allows
from .sys import IAMSys

__all__ = ["IAMSys", "Policy", "Statement", "policy_allows"]
