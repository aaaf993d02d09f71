"""Dashboard service stub: hardcoded local user (reference
gyre/services/dashboard.py:1-15).

Copy of gyre_tpu/services/dashboard.py."""

from ..generated import dashboard_pb2 as dpb


class DashboardServiceServicer:
    def GetMe(self, request, context):
        user = dpb.User(id="gyre-tpu-local")
        org = user.organizations.add()
        org.organization.id = "gyre-tpu-local"
        org.organization.name = "gyre-tpu"
        org.role = dpb.MEMBER
        return user
